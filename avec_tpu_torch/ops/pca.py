"""PCA through the eigendecomposition of the covariance (port of
avec_tpu/ops/pca.py). Eigenvectors are defined up to sign."""

from typing import Optional

import torch

from avec_tpu_torch.models.zoo import resolve_device


class PCA:
    """fit / transform / inverse_transform / fit_transform over (N, D) data
    (pca.py:19-48), in fp32 on `device` (the card unless the caller passes
    device="cpu"): the components are the eigenvectors of the unbiased
    covariance by falling eigenvalue (`torch.linalg.eigh`), the first
    `n_components` of them (all when None)."""

    def __init__(self, n_components: Optional[int] = None, device="cuda"):
        self.n_components = n_components
        self.device = resolve_device(device)
        self.mean = None
        self.components = None
        self.explained_variance = None

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def fit(self, x) -> "PCA":
        x = self._t(x)
        self.mean = x.mean(dim=0)
        xc = x - self.mean
        cov = xc.T @ xc / (x.shape[0] - 1)
        eigvals, eigvecs = torch.linalg.eigh(cov)
        order = torch.argsort(eigvals, descending=True)
        k = self.n_components or x.shape[1]
        self.explained_variance = eigvals[order][:k]
        self.components = eigvecs[:, order][:, :k]
        return self

    def transform(self, x) -> torch.Tensor:
        return (self._t(x) - self.mean) @ self.components

    def inverse_transform(self, z) -> torch.Tensor:
        return self._t(z) @ self.components.T + self.mean

    def fit_transform(self, x) -> torch.Tensor:
        return self.fit(x).transform(x)

"""avec_tpu_torch: the PyTorch / CUDA (H100) port of avec_tpu.

It imports torch and numpy only, never JAX or the `avec_tpu` package. Its
modules mirror `avec_tpu/` (ops/, models/, decode/, train/, serve.py,
convert.py).
Every Pallas TPU kernel on a ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use; each has a plain PyTorch twin that the
CPU runs and that the kernel is held against on the card.
"""

from avec_tpu_torch.models.zoo import AudioVisualEfficientConformerInterCTC

__all__ = ["AudioVisualEfficientConformerInterCTC"]

"""Multi-head attention (port of avec_tpu/ops/attention.py).

Sequences are (B, T, D); masks are boolean, additive -1e9. The rel-pos layer
computes its relative scores through the exact sin/cos factorization (the JAX
in-model default), or, with `use_flash`, through the flash kernel of
`ops/flash_attention.py` with key-padding lengths. The Transformer-XL layer
(`RelPosMultiHeadSelfAttention`, the causal audio encoder's) computes them
through the relative table and the skew of `rel_to_abs`; its grouped form
(`GroupedRelPosMultiHeadSelfAttention`) folds groups of G frames into the
head width and attends at T / G resolution. `NdMultiHeadAttention` attends
over the flattened positions of an N-d grid.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from avec_tpu_torch.ops.flash_attention import rel_pos_flash_attention
from avec_tpu_torch.ops.layers import (Dropout, Linear, avg_pool,
                                       upsample_nearest)
from avec_tpu_torch.ops.masks import apply_mask, min_pool_mask
from avec_tpu_torch.ops.pos_embeddings import (device_constant,
                                               grouped_relative_pos_encoding,
                                               relative_pos_encoding)


def rel_to_abs(scores: torch.Tensor, causal: bool) -> torch.Tensor:
    """Relative-indexed -> absolute-indexed scores (attention.py:48-69).

    Full context: (B, H, T, Th + 2T - 1) -> (B, H, T, Th + T); causal:
    (B, H, T, Th + T) -> (B, H, T, Th + T). The pad / flatten / reshape /
    slice skew: causal pads one column on the left, flattens, pads
    t2 - t1 entries on the left and drops the first row."""
    b, h, t1, t2 = scores.shape
    if causal:
        x = F.pad(scores, (1, 0)).reshape(b, h, t1 * (1 + t2))
        x = F.pad(x, (t2 - t1, 0)).reshape(b, h, 1 + t1, t2)
        return x[:, :, 1:]
    x = F.pad(scores, (0, 1)).reshape(b, h, t1 * (t2 + 1))
    x = F.pad(x, (0, t2 - t1)).reshape(b, h, 1 + t1, t2)
    return x[:, :, :t1, t1 - 1:]


def _split_heads(x, num_heads, dim_head):
    b = x.shape[0]
    return x.reshape(b, -1, num_heads, dim_head).transpose(1, 2)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _attend(scores, v, mask, dropout=None):
    scores = apply_mask(scores, mask)
    att = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    if dropout is not None:
        att = dropout(att)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


def _factorized_inv_freq(d_model: int, device) -> torch.Tensor:
    """(d_model // 2,) 1 / 10000^(2i / d_model), computed in fp64 by numpy
    and rounded to fp32."""
    return device_constant(
        ("factorized_inv_freq", d_model), device,
        lambda: torch.from_numpy((1.0 / (10000.0 ** (
            2.0 * np.arange(d_model // 2) / d_model))).astype(np.float32)))


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA (attention.py:92-170). With `attn_drop_rate`
    the attention weights take a `Dropout` in training mode, its mask drawn
    from the owning model's generator. `weight_init` / `bias_init` are the
    projections' inits (`Linear`): the GPT's are "normal_02" / "zeros".
    `output_proj=False` leaves the output projection out: the layer returns
    the merged heads. `dim_kv` is accepted as the JAX layer declares it
    (attention.py:101); neither package reads it."""

    def __init__(self, dim_model: int, num_heads: int,
                 attn_drop_rate: float = 0.0, weight_init: str = "default",
                 bias_init: str = "default", output_proj: bool = True,
                 dim_kv=None):
        super().__init__()
        self.dim_model, self.num_heads = dim_model, num_heads
        self.dim_kv = dim_kv
        inits = dict(weight_init=weight_init, bias_init=bias_init)
        self.query_layer = Linear(dim_model, dim_model, **inits)
        self.key_layer = Linear(dim_model, dim_model, **inits)
        self.value_layer = Linear(dim_model, dim_model, **inits)
        self.output_layer = (Linear(dim_model, dim_model, **inits)
                             if output_proj else None)
        self.dropout = Dropout(attn_drop_rate) if attn_drop_rate > 0 else None

    @property
    def dim_head(self):
        return self.dim_model // self.num_heads

    def _proj_out(self, o):
        return o if self.output_layer is None else self.output_layer(o)

    def _heads(self, q, k, v):
        q, k, v = self.query_layer(q), self.key_layer(k), self.value_layer(v)
        return tuple(_split_heads(a, self.num_heads, self.dim_head)
                     for a in (q, k, v))

    def forward(self, x, mask=None, lengths=None):
        q, k, v = self._heads(x, x, x)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / self.dim_head ** 0.5
        return self._proj_out(_merge_heads(_attend(scores, v, mask,
                                                      self.dropout)))


class NdMultiHeadAttention(MultiHeadAttention):
    """MHA over the flattened positions of an N-d grid (attention.py:
    171-182): (B, d1, ..., dn, C) -> (B, N, C) -> attention -> (B, d1, ...,
    dn, C). A mask spans the N flattened positions."""

    def forward(self, x, mask=None, lengths=None):
        shape = x.shape
        out = super().forward(x.reshape(shape[0], -1, shape[-1]), mask,
                              lengths)
        return out.reshape(shape[:-1] + (out.shape[-1],))


class RelPos1dMultiHeadAttention(MultiHeadAttention):
    """Relative-position MHA (attention.py:187) on the factorized path, or the
    flash kernel when `use_flash` (attention.py:277-294).

    The flash route takes key-padding `lengths`; given none it recovers them
    from a (B, 1, 1, T) mask, and a full (B, 1, T, T) mask falls back to the
    exact factorized path. `use_kernel=False` runs the flash route through
    the kernel's plain version on any device. `causal` takes the causal
    relative table (positions T - 1 down to 0) through the causal skew of
    `rel_to_abs`, never the flash route (attention.py:277-307)."""

    def __init__(self, dim_model: int, num_heads: int, use_flash: bool = False,
                 causal: bool = False):
        super().__init__(dim_model, num_heads)
        self.use_flash = use_flash
        self.causal = causal
        self.use_kernel = True
        self.pos_layer = Linear(dim_model, dim_model)

    def _rel_scores_factorized(self, q, t):
        d_model = self.dim_model
        dtype = q.dtype
        w = self.pos_layer.weight.t().reshape(d_model, self.num_heads,
                                              self.dim_head).to(dtype)
        ws, wc = w[0::2], w[1::2]
        bh = self.pos_layer.bias.reshape(self.num_heads, self.dim_head).to(dtype)
        us = torch.einsum("bhid,mhd->bhim", q, ws)
        uc = torch.einsum("bhid,mhd->bhim", q, wc)
        pos = torch.arange(t, dtype=torch.float32, device=q.device)
        ang = pos[:, None] * _factorized_inv_freq(d_model, q.device)[None, :]
        sin_t, cos_t = torch.sin(ang).to(dtype), torch.cos(ang).to(dtype)
        a1 = us * sin_t + uc * cos_t
        a2 = uc * sin_t - us * cos_t
        scores = (torch.einsum("bhim,jm->bhij", a1, cos_t)
                  + torch.einsum("bhim,jm->bhij", a2, sin_t))
        return scores + torch.einsum("bhid,hd->bhi", q, bh)[..., None]

    def forward(self, x, mask=None, lengths=None):
        t = x.shape[1]
        q, k, v = self._heads(x, x, x)
        flash_ok = self.use_flash and not self.causal
        if flash_ok and lengths is None and mask is not None:
            if mask.shape[2] == 1:
                lengths = mask[:, 0, 0, :].sum(dim=-1).to(torch.int32)
            else:
                flash_ok = False
        if flash_ok:
            o = rel_pos_flash_attention(
                q, k, v, self.pos_layer.weight.t(), self.pos_layer.bias,
                self.dim_model, self.num_heads, lengths=lengths,
                use_kernel=self.use_kernel)
            return self._proj_out(_merge_heads(o))
        if self.causal:
            pe = relative_pos_encoding(t, self.dim_model, True,
                                       device=x.device).to(q.dtype)
            e = _split_heads(self.pos_layer(pe), self.num_heads,
                             self.dim_head)
            scores_e = rel_to_abs(torch.einsum("bhqd,xhkd->bhqk", q, e), True)
        else:
            scores_e = self._rel_scores_factorized(q, t)
        scores = (torch.einsum("bhqd,bhkd->bhqk", q, k)
                  + scores_e) / self.dim_head ** 0.5
        return self._proj_out(_merge_heads(_attend(scores, v, mask)))


class RelPosPatch1dMultiHeadAttention(RelPos1dMultiHeadAttention):
    """Patch attention (attention.py:313-351): avg-pool by patch_size, attend
    with a min-pooled mask, nearest-upsample, crop to T."""

    def __init__(self, dim_model: int, num_heads: int, patch_size: int = 3):
        super().__init__(dim_model, num_heads, use_flash=False)
        self.patch_size = patch_size

    def forward(self, x, mask=None, lengths=None):
        t, p = x.shape[1], self.patch_size
        pad = (-t) % p
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            if mask is None:
                mask = torch.ones((1, 1, 1, t), dtype=torch.bool,
                                  device=x.device)
                mask = torch.nn.functional.pad(mask, (0, pad), value=False)
            else:
                qpad = pad if mask.shape[2] > 1 else 0
                mask = torch.nn.functional.pad(mask, (0, pad, 0, qpad),
                                               value=False)
        if mask is not None:
            mask = min_pool_mask(mask, p)
        x = avg_pool(x, (p,), (p,))
        o = super().forward(x, mask)
        return upsample_nearest(o, p, axis=1)[:, :t]


class RelPosMultiHeadSelfAttention(MultiHeadAttention):
    """Transformer-XL rel-pos self-attention with the u and v biases and a
    key/value cache (attention.py:354-404): scores = ((q + u) k^T +
    rel_to_abs((q + v) E^T)) / sqrt(d), E = pos_layer(relative table), the
    table causal (positions Th + T - 1 .. 0) when `causal`.

    `hidden` {"K", "V"}: (B, Th, D) projected keys / values of past frames,
    concatenated before the new frames' ones before the heads are split;
    the mask then spans (T, Th + T). With `return_hidden` the call returns
    (out, {"K", "V"}), the concatenated keys / values, detached."""

    def __init__(self, dim_model: int, num_heads: int, causal: bool = False,
                 attn_drop_rate: float = 0.0, max_pos_encoding: int = 10000):
        super().__init__(dim_model, num_heads, attn_drop_rate)
        self.causal = causal
        self.pos_layer = Linear(dim_model, dim_model)
        self.u = nn.Parameter(torch.zeros(dim_model))
        self.v = nn.Parameter(torch.zeros(dim_model))

    def forward(self, x, mask=None, lengths=None, hidden=None,
                return_hidden: bool = False):
        t, dtype = x.shape[1], x.dtype
        q, k, v = self.query_layer(x), self.key_layer(x), self.value_layer(x)
        if hidden is not None:
            k = torch.cat([hidden["K"].to(dtype), k], dim=1)
            v = torch.cat([hidden["V"].to(dtype), v], dim=1)
        th = k.shape[1] - t
        split = lambda a: _split_heads(a, self.num_heads, self.dim_head)
        qu, qv = split(q + self.u.to(dtype)), split(q + self.v.to(dtype))
        e = self.pos_layer(relative_pos_encoding(
            t, self.dim_model, self.causal, hidden_len=th,
            device=x.device).to(dtype))
        e = split(e)[0]                                   # (H, R, d)
        scores_k = torch.einsum("bhqd,bhkd->bhqk", qu, split(k))
        scores_e = rel_to_abs(torch.einsum("bhqd,hkd->bhqk", qv, e),
                              self.causal)
        scores = (scores_k + scores_e) / self.dim_head ** 0.5
        out = self._proj_out(_merge_heads(_attend(scores, split(v),
                                                     mask, self.dropout)))
        if return_hidden:
            return out, {"K": k.detach(), "V": v.detach()}
        return out


class GroupedRelPosMultiHeadSelfAttention(RelPosMultiHeadSelfAttention):
    """Grouped Transformer-XL self-attention (attention.py:406-491): groups
    of `group_size` (G) consecutive frames are folded into the head width,
    dim_head = G * D / H, so the heads attend over T / G groups.

    q, k and v are zero-padded to a multiple of G; when the keys were padded
    and no mask is given, a key mask of the true length is built; a mask is
    padded likewise, then taken at every G-th query and key. The output
    unfolds back to frames, is cut to T, then projected. With `hidden` the
    first Th % G cached frames are left out of the keys, and the returned
    cache is the whole of it followed by this call's keys / values."""

    def __init__(self, dim_model: int, num_heads: int, group_size: int = 3,
                 causal: bool = False, attn_drop_rate: float = 0.0,
                 max_pos_encoding: int = 10000):
        super().__init__(dim_model, num_heads, causal, attn_drop_rate,
                         max_pos_encoding)
        self.group_size = group_size

    @property
    def dim_head(self):
        return (self.group_size * self.dim_model) // self.num_heads

    def forward(self, x, mask=None, lengths=None, hidden=None,
                return_hidden: bool = False):
        t, dtype, g = x.shape[1], x.dtype, self.group_size
        q, k, v = self.query_layer(x), self.key_layer(x), self.value_layer(x)
        if hidden is not None:
            hk, hv = hidden["K"].to(dtype), hidden["V"].to(dtype)
            trim = hk.shape[1] % g
            new_hidden = {"K": torch.cat([hk, k], dim=1).detach(),
                          "V": torch.cat([hv, v], dim=1).detach()}
            k = torch.cat([hk[:, trim:], k], dim=1)
            v = torch.cat([hv[:, trim:], v], dim=1)
        else:
            new_hidden = {"K": k.detach(), "V": v.detach()}
        pad_q, pad_kv = (-t) % g, (-k.shape[1]) % g
        if pad_q:
            q = F.pad(q, (0, 0, 0, pad_q))
        if pad_kv:
            k, v = F.pad(k, (0, 0, 0, pad_kv)), F.pad(v, (0, 0, 0, pad_kv))
        if mask is None and pad_kv:
            mask = F.pad(torch.ones((1, 1, 1, k.shape[1] - pad_kv),
                                    dtype=torch.bool, device=x.device),
                         (0, pad_kv), value=False)
        elif mask is not None and (pad_q or pad_kv):
            qpad = pad_q if mask.shape[2] > 1 else 0
            mask = F.pad(mask, (0, pad_kv, 0, qpad), value=False)
        th = k.shape[1] - q.shape[1]
        split = lambda a: _split_heads(a, self.num_heads, self.dim_head)
        qu, qv = split(q + self.u.to(dtype)), split(q + self.v.to(dtype))
        e = self.pos_layer(grouped_relative_pos_encoding(
            q.shape[1], self.dim_model, g, self.causal, hidden_len=th,
            device=x.device).to(dtype))
        e = split(e)[0]                                   # (H, R / G, d)
        scores_k = torch.einsum("bhqd,bhkd->bhqk", qu, split(k))
        scores_e = rel_to_abs(torch.einsum("bhqd,hkd->bhqk", qv, e),
                              self.causal)
        scores = (scores_k + scores_e) / self.dim_head ** 0.5
        if mask is not None:
            mask = mask[:, :, ::g, ::g]
        o = _attend(scores, split(v), mask, self.dropout)
        o = o.transpose(1, 2).reshape(x.shape[0], -1, self.dim_model)[:, :t]
        out = self._proj_out(o)
        if return_hidden:
            return out, new_hidden
        return out


att_dict = {
    "MultiHeadAttention": MultiHeadAttention,
    "NdMultiHeadAttention": NdMultiHeadAttention,
    "RelPos1dMultiHeadAttention": RelPos1dMultiHeadAttention,
    "RelPosPatch1dMultiHeadAttention": RelPosPatch1dMultiHeadAttention,
    "RelPosMultiHeadSelfAttention": RelPosMultiHeadSelfAttention,
    "GroupedRelPosMultiHeadSelfAttention": GroupedRelPosMultiHeadSelfAttention,
}


def make_attention(dim_model: int, att_params: dict) -> nn.Module:
    """Instantiate from a {'class': .., 'params': ..} spec."""
    return att_dict[att_params["class"]](dim_model=dim_model,
                                         **dict(att_params.get("params", {})))

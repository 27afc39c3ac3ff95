"""The Transformer network and the GPT language-model family (port of
avec_tpu/models/transformer.py:58-167).

Pre-norm blocks (x += drop(MHA(LN(x))); x += FFN(x), the FFN GELU without
inner dropout), the causal mask band(right_context=0) with the padding
lengths when given, an additive position embedding ("sin" or "learned")
and a final LayerNorm. Linear and Embedding weights are N(0, 0.02), biases
zero, LayerNorms ones and zeros, a learned position table zeros.

Parameter names follow the reference state_dict: embedding.weight,
transformer.pos_embedding.pos_encoding, transformer.blocks.{i}.
{self_att_module.{norm, attention.*}, ff_module.layers.{0,1,4}},
transformer.layernorm, head.
"""

from typing import Dict, Optional

import torch
import torch.nn as nn

from avec_tpu_torch.models.conformer import AttentionModule, FeedForwardModule
from avec_tpu_torch.ops.layers import Dropout, Embedding, LayerNorm, Linear
from avec_tpu_torch.ops.masks import band_mask, padding_mask
from avec_tpu_torch.ops.pos_embeddings import PosEmbedding1d, SinPosEmbedding

GPT_CONFIGS = {
    "GPT-Tiny": dict(dim_model=64, num_blocks=2, num_heads=2),
    "GPT-Small": dict(dim_model=768, num_blocks=12, num_heads=12),
    "GPT-Medium": dict(dim_model=1024, num_blocks=24, num_heads=16),
    "GPT-Large": dict(dim_model=1536, num_blocks=24, num_heads=16),
    "GPT-XL": dict(dim_model=2048, num_blocks=24, num_heads=24),
    "GPT-2.7B": dict(dim_model=2560, num_blocks=32, num_heads=32),
    "GPT-6.7B": dict(dim_model=4096, num_blocks=32, num_heads=32),
    "GPT-13.0B": dict(dim_model=5140, num_blocks=40, num_heads=40),
    "GPT-175.0B": dict(dim_model=12288, num_blocks=96, num_heads=96),
}

# (lr_max, lr_min) of the cosine schedule per size
GPT_LR = {
    "GPT-Tiny": (6e-4, 6e-5),
    "GPT-Small": (6e-4, 6e-5),
    "GPT-Medium": (3e-4, 3e-5),
    "GPT-Large": (2.5e-4, 2.5e-5),
    "GPT-XL": (2e-4, 2e-5),
    "GPT-2.7B": (1.6e-4, 1.6e-5),
    "GPT-6.7B": (1.2e-4, 1.2e-5),
    "GPT-13.0B": (1e-4, 1e-5),
    "GPT-175.0B": (0.6e-4, 0.6e-5),
}


class TransformerBlock(nn.Module):
    """Pre-norm attention + FFN block (transformer.py:58-86): x +=
    drop(MHA(LN(x))), x += FFN(x), the FFN GELU without inner dropout and
    its Linear layers N(0, 0.02) with zero biases."""

    def __init__(self, dim_model: int, att_params: Dict, ff_ratio: int = 4,
                 drop_rate: float = 0.1):
        super().__init__()
        self.self_att_module = AttentionModule(dim_model, att_params,
                                               drop_rate, fused_att=False)
        self.ff_module = FeedForwardModule(
            dim_model, dim_model * ff_ratio, drop_rate, fused_ffn=False,
            act_fun="GELU", inner_dropout=False, weight_init="normal_02",
            bias_init="zeros")

    def forward(self, x, mask=None):
        x = x + self.self_att_module(x, mask=mask)
        return x + self.ff_module(x)


class Transformer(nn.Module):
    """Position embedding ("sin", "learned" or None) -> dropout -> causal
    blocks -> LayerNorm (transformer.py:89-126). The mask is the causal
    band (right context 0), and the key padding of `lengths` when given."""

    def __init__(self, dim_model: int, num_blocks: int, att_params: Dict,
                 ff_ratio: int = 4, emb_drop_rate: float = 0.1,
                 drop_rate: float = 0.1, pos_embedding: Optional[str] = None,
                 max_pos_encoding: int = 2048):
        super().__init__()
        if pos_embedding not in (None, "sin", "learned"):
            raise ValueError(f"pos_embedding {pos_embedding!r}")
        self.pos_embedding = (
            None if pos_embedding is None else
            (SinPosEmbedding if pos_embedding == "sin" else PosEmbedding1d)(
                max_pos_encoding, dim_model))
        self.dropout = Dropout(emb_drop_rate)
        self.blocks = nn.ModuleList([
            TransformerBlock(dim_model, att_params, ff_ratio, drop_rate)
            for _ in range(num_blocks)])
        self.layernorm = LayerNorm(dim_model)

    def forward(self, x, lengths=None):
        if self.pos_embedding is not None:
            x = self.pos_embedding(x)
        x = self.dropout(x)
        t = x.shape[1]
        mask = band_mask(t, None, 0, device=x.device)
        if lengths is not None:
            mask = mask & padding_mask(lengths, t)
        for block in self.blocks:
            x = block(x, mask=mask)
        return self.layernorm(x)


class GPTNet(nn.Module):
    """Embedding -> causal Transformer -> vocabulary head
    (transformer.py:129-167); forward(ids (B, L)) -> logits (B, L, V)."""

    def __init__(self, vocab_size: int = 25000,
                 padding_idx: Optional[int] = None,
                 max_pos_encoding: int = 2048, model: str = "GPT-Small",
                 pos_embedding: str = "learned", drop_rate: float = 0.1):
        super().__init__()
        cfg = GPT_CONFIGS[model]
        d = cfg["dim_model"]
        self.embedding = Embedding(vocab_size, d, padding_idx=padding_idx,
                                   embedding_init="normal_02")
        self.transformer = Transformer(
            dim_model=d, num_blocks=cfg["num_blocks"],
            att_params={"class": "MultiHeadAttention",
                        "params": {"num_heads": cfg["num_heads"],
                                   "attn_drop_rate": drop_rate,
                                   "weight_init": "normal_02",
                                   "bias_init": "zeros"}},
            ff_ratio=4, emb_drop_rate=drop_rate, drop_rate=drop_rate,
            pos_embedding=pos_embedding, max_pos_encoding=max_pos_encoding)
        self.head = Linear(d, vocab_size, weight_init="normal_02",
                           bias_init="zeros")

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.head(self.transformer(self.embedding(ids)))

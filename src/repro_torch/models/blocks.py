"""The ATTN block (port of ``repro/models/blocks.py``): norm -> attention
-> residual -> norm -> dense FFN -> residual, for prefill and paged
decode. Other block kinds and MoE come with later slices."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import attention, layers


def dense_ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    h = layers.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def apply_block_prefill(bp: dict, x: torch.Tensor, cfg,
                        positions: torch.Tensor, cache_len: int
                        ) -> Tuple[torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]:
    h = layers.rms_norm(x, bp["norm1"]["scale"])
    mix, cache = attention.attention_prefill(
        bp["mixer"], h, cfg, positions=positions, cache_len=cache_len)
    x = x + mix
    h = layers.rms_norm(x, bp["norm2"]["scale"])
    return x + dense_ffn(bp["ffn"], h), cache


def apply_block_decode_paged(bp: dict, x: torch.Tensor, pool_k: torch.Tensor,
                             pool_v: torch.Tensor, cfg, lens: torch.Tensor,
                             positions: torch.Tensor, table: torch.Tensor,
                             slots: torch.Tensor) -> torch.Tensor:
    """Decode block over this layer's paged KV (written in place)."""
    h = layers.rms_norm(x, bp["norm1"]["scale"])
    x = x + attention.attention_decode_paged(
        bp["mixer"], h, pool_k, pool_v, cfg, lens=lens, positions=positions,
        table=table, slots=slots)
    h = layers.rms_norm(x, bp["norm2"]["scale"])
    return x + dense_ffn(bp["ffn"], h)

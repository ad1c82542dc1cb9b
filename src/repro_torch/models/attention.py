"""Attention (port of ``repro/models/attention.py``): GQA projections with
QK-norm and RoPE, plain blockwise attention for prefill, and paged decode
attention through the hand-written kernel.

Prefill attention stays plain tensor code, as in the JAX package (its
Pallas ``flash_attention`` is not on the serving path). Decode writes the
new K/V into the block pools in place, then attends through
:func:`repro_torch.kernels.paged_attention.paged_attention`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import layers

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """Additive mask bias (0 or NEG_INF) in float32. A key position < 0
    marks an empty slot. q_pos: (Sq,), k_pos: (Sk,) -> (Sq, Sk)."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG_INF)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0,
                        q_positions: Optional[torch.Tensor] = None,
                        k_positions: Optional[torch.Tensor] = None,
                        q_block: int = 512, k_block: int = 512,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over (q_block, k_block) tiles, the JAX
    ``blockwise_attention`` arithmetic: scores in float32, probabilities
    cast to v's dtype before the PV product, denominator clamped at 1e-30.
    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D). Returns (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=dev)
    if k_positions is None:
        k_positions = torch.arange(Sk, dtype=torch.int32, device=dev)
    q_block = min(q_block, Sq)
    k_block = min(k_block, Sk)
    pq = (-Sq) % q_block
    pk = (-Sk) % k_block
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_positions = F.pad(q_positions, (0, pq), value=-(10 ** 9))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        k_positions = F.pad(k_positions, (0, pk), value=-1)
    nq, nk = (Sq + pq) // q_block, (Sk + pk) // k_block

    outs = []
    for i in range(nq):
        qs = slice(i * q_block, (i + 1) * q_block)
        qi = q[:, qs].reshape(B, q_block, Hkv, g, D).float()
        m = torch.full((B, q_block, Hkv, g), NEG_INF, device=dev)
        l = torch.zeros((B, q_block, Hkv, g), device=dev)
        acc = torch.zeros((B, q_block, Hkv, g, D), device=dev)
        for j in range(nk):
            ks = slice(j * k_block, (j + 1) * k_block)
            kj, vj = k[:, ks], v[:, ks]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qi, kj.float()) * scale
            s = s + _mask_bias(q_positions[qs], k_positions[ks],
                               causal=causal, window=window)[
                None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(vj.dtype).float(), vj.float())
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.cat(outs, dim=1).reshape(B, nq * q_block, Hq, D)[:, :Sq]
    return out.to(q.dtype)


def qkv_project(params: dict, x: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, params["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, params["wv"])
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_scale"])
        k = layers.rms_norm(k, params["k_scale"])
    return q, k, v


def _project_rope(params, x, cfg, positions):
    q, k, v = qkv_project(params, x, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def fill_cache_from_prefill(k: torch.Tensor, v: torch.Tensor,
                            cache_len: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last ``cache_len`` of S tokens as a dense cache: slot s holds
    token s + cache_len * floor((S-1-s)/cache_len), clipped to [0, S) —
    slots past S (a block-padded cache) hold token 0, at positions the
    causal mask hides until decode overwrites them."""
    S = k.shape[1]
    s_idx = torch.arange(cache_len, device=k.device)
    t_idx = s_idx + cache_len * torch.div(S - 1 - s_idx, cache_len,
                                          rounding_mode="floor")
    t = t_idx.clamp(0, S - 1)
    return k[:, t], v[:, t]


def attention_prefill(params: dict, x: torch.Tensor, cfg, *,
                      positions: torch.Tensor, cache_len: int
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """Full-sequence causal attention that also returns the (k, v) cache
    of ``cache_len`` slots. x: (B, S, d)."""
    q, k, v = _project_rope(params, x, cfg, positions)
    out = blockwise_attention(q, k, v, causal=cfg.causal)
    out = torch.einsum("bshe,hed->bsd", out, params["wo"])
    return out, fill_cache_from_prefill(k, v, cache_len)


def _paged_attend(q: torch.Tensor, pool_k: torch.Tensor,
                  pool_v: torch.Tensor, table: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over one layer's pool blocks. q: (B, 1, Hq, D);
    table: (B, nc) int32; lens: (B,) int32, ``pos + 1`` per row for a
    query token at absolute position ``pos`` (already written)."""
    return paged_attention(q[:, 0], pool_k, pool_v, table, lens)[:, None]


def attention_decode_paged(params: dict, x: torch.Tensor,
                           pool_k: torch.Tensor, pool_v: torch.Tensor, cfg, *,
                           lens: torch.Tensor, positions: torch.Tensor,
                           table: torch.Tensor,
                           slots: torch.Tensor) -> torch.Tensor:
    """One-token decode, write then attend. x: (B, 1, d); pool_k/v: this
    layer's (n_blocks, bs, Hkv, D) pools, updated in place (no pool
    copy); ``slots`` = ``table[b, pos // bs] * bs + pos % bs`` per row,
    the flat slot the new K/V lands in (pad rows point at the scratch
    block); ``lens`` = ``pos + 1`` per row."""
    q, k, v = _project_rope(params, x, cfg, positions)
    Hkv, D = pool_k.shape[-2:]
    pool_k.view(-1, Hkv, D).index_copy_(0, slots, k[:, 0].to(pool_k.dtype))
    pool_v.view(-1, Hkv, D).index_copy_(0, slots, v[:, 0].to(pool_v.dtype))
    out = _paged_attend(q, pool_k, pool_v, table, lens)
    return torch.einsum("bshe,hed->bsd", out, params["wo"])

"""Model assembly (port of ``repro/models/model.py``): embedding, the
layer loop, the tied or separate unembedding, prefill, and paged decode.

Params are the per-layer dicts of :mod:`repro_torch.bridge`. Where the
JAX package scans over stacked layers, the port loops over
``params["layers"]`` in Python. Only the write-then-attend lowering of
``decode_step_paged`` is ported: each layer writes its new K/V into the
pools, then attends through the paged-attention kernel.

This slice serves dense, attention-only, RMS-norm, RoPE, SwiGLU text
models (``qwen3_1_7b``); :func:`check_supported` names what waits.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, layers
from repro_torch.models.paged_cache import PagedKVCache, paged_compatible


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config this slice of the port cannot run."""
    missing = []
    if not paged_compatible(cfg):
        missing.append("non-attention blocks, sliding windows or "
                       "bidirectional attention")
    if cfg.n_experts:
        missing.append("MoE FFNs (next slice)")
    if cfg.norm != "rmsnorm" or cfg.rope != "rope" \
            or cfg.activation != "swiglu" or cfg.qkv_bias \
            or cfg.frontend != "none" or cfg.logits_softcap:
        missing.append("norm/rope/activation/bias/frontend/softcap "
                       "variants other than qwen3's")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: "
                                  + "; ".join(missing))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random params with the JAX ``init_params`` distributions (dense
    weights ``N(0, 1/fan_in)``, norm and QK-norm scales zero), drawn from
    ``generator`` on ``device`` (the generator's own device)."""
    check_supported(cfg)
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator lives on {generator.device}, params "
                         f"are asked for on {device}")
    dtype = getattr(torch, cfg.dtype)
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)

    def init(shape, fan_in=None):
        return layers.dense_init(generator, shape, dtype, fan_in=fan_in)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params: Dict[str, Any] = {
        "embed": init((cfg.vocab_size, d), fan_in=d),
        "final_norm": {"scale": zeros(d)},
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init((d, cfg.vocab_size))
    for _ in range(cfg.n_layers):
        mixer = {"wq": init((d, hq, hd), fan_in=d),
                 "wk": init((d, hkv, hd), fan_in=d),
                 "wv": init((d, hkv, hd), fan_in=d),
                 "wo": init((hq, hd, d), fan_in=hq * hd)}
        if cfg.qk_norm:
            mixer["q_scale"] = zeros(hd)
            mixer["k_scale"] = zeros(hd)
        params["layers"].append({
            "norm1": {"scale": zeros(d)}, "norm2": {"scale": zeros(d)},
            "mixer": mixer,
            "ffn": {"w_up": init((d, ff)), "w_down": init((ff, d)),
                    "w_gate": init((d, ff))}})
    return params


class Model:
    """Functional model bound to a config (params are passed per call)."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]

    def unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["lm_head"]

    def prefill(self, params, tokens: torch.Tensor, max_seq: int
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Run the whole prompt. tokens: (B, S) int. Returns last-position
        logits (B, 1, V) and the (k, v) cache, each
        ``(n_layers, B, max_seq, Hkv, D)``."""
        cfg = self.cfg
        x = self.embed(params, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        ks, vs = [], []
        for bp in params["layers"]:
            x, (k, v) = blocks.apply_block_prefill(bp, x, cfg, positions,
                                                   max_seq)
            ks.append(k)
            vs.append(v)
        x = layers.rms_norm(x, params["final_norm"]["scale"])
        return self.unembed(params, x[:, -1:]), (torch.stack(ks),
                                                 torch.stack(vs))

    def decode_step_paged(self, params, token: torch.Tensor,
                          pools: PagedKVCache, table: torch.Tensor,
                          pos: int) -> torch.Tensor:
        """One decode step over the block pools, which it updates in
        place. token: (B, 1) int; table: (B, nc) int32 on the pools'
        device, shared by every layer; pos: the host's absolute position
        of this token. Returns logits (B, 1, V)."""
        cfg = self.cfg
        x = self.embed(params, token)
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        bs = pools.k.shape[2]
        slots = table[:, pos // bs].long() * bs + pos % bs
        lens = torch.full((table.shape[0],), pos + 1, dtype=torch.int32,
                          device=x.device)
        for i, bp in enumerate(params["layers"]):
            x = blocks.apply_block_decode_paged(
                bp, x, pools.k[i], pools.v[i], cfg, lens, positions, table,
                slots)
        x = layers.rms_norm(x, params["final_norm"]["scale"])
        return self.unembed(params, x)

"""Shared layer primitives (port of ``repro/models/layers.py``): RMS norm,
SiLU, RoPE, and the dense initialiser."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

silu = F.silu


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale`` (zero-initialised
    scales are the identity), cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,) in float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard RoPE, split-halves convention: dims ``[0, D/2)`` pair with
    ``[D/2, D)``. x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions.float()[..., None] * freqs          # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape, dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """``N(0, 1) / sqrt(fan_in)`` drawn in float32, then cast: the JAX
    ``dense_init`` distribution (not its bits, which come from a
    ``jax.random`` stream). Lands on the generator's device."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * fan_in ** -0.5).to(dtype)

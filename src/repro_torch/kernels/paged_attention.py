"""Paged decode attention: one query token per row, reading K/V through a
block table (vLLM-style), with an online softmax.

:func:`paged_attention` launches the hand-written CUDA kernel
(``csrc/paged_attention.cu``, the port of the Pallas kernel at
``src/repro/kernels/paged_attention.py:74``) on CUDA tensors and runs
:func:`paged_attention_plain` on CPU tensors. A CUDA tensor never falls
back to the plain version: the kernel launches or the call raises.

Slot ``(c, o)`` of a row holds absolute position ``c * bs + o``; slots
at or past ``seq_lens[b]`` are masked, so padding columns (the zero
block) and unwritten slots are never attended. ``seq_lens`` must be
>= 1 everywhere.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = "src/repro/kernels/paged_attention.py:74"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor,
                          seq_lens: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's plain PyTorch version (mirrors
    ``src/repro/kernels/ref.py:25``): gather each row's blocks through
    the table, then masked softmax attention in float32."""
    B, Hq, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    g = Hq // Hkv
    n_c = block_table.shape[1]
    scale = D ** -0.5 if scale is None else scale
    idx = block_table.long()
    kg = k_pool[idx].reshape(B, n_c * bs, Hkv, D).float()
    vg = v_pool[idx].reshape(B, n_c * bs, Hkv, D).float()
    qf = q.reshape(B, Hkv, g, D).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qf, kg)
    slot = torch.arange(n_c * bs, device=q.device)
    bias = torch.where(slot[None, :] < seq_lens[:, None].long(), 0.0, NEG_INF)
    p = torch.softmax(s + bias[:, None, None, :], dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, vg)
    return out.reshape(B, Hq, D).to(q.dtype)


def _check(q, k_pool, v_pool, block_table, seq_lens) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention wants q (B, Hq, D) and k/v pools "
                         f"(n_blocks, bs, Hkv, D); got q {tuple(q.shape)}, "
                         f"k {tuple(k_pool.shape)}, v {tuple(v_pool.shape)}")
    B, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    if k_pool.shape[3] != D or Hq % Hkv:
        raise ValueError(f"head dims disagree or Hq={Hq} is not a multiple "
                         f"of Hkv={Hkv}: q {tuple(q.shape)}, "
                         f"pool {tuple(k_pool.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"block_table must be (B={B}, n_cols) and seq_lens "
                         f"(B,); got {tuple(block_table.shape)} and "
                         f"{tuple(seq_lens.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and pools must share float32 or bfloat16; got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_table and seq_lens must be int32")
    tensors = (q, k_pool, v_pool, block_table, seq_lens)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention inputs lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention inputs must be contiguous")


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); k/v_pool: (n_blocks, bs, Hkv, D); block_table:
    (B, n_cols) int32; seq_lens: (B,) int32 >= 1. Returns (B, Hq, D) in
    q's dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream (``paged_attention.launches`` counts
    those launches)."""
    _check(q, k_pool, v_pool, block_table, seq_lens)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_table,
                                     seq_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    B, Hq, D = q.shape
    n_blocks, bs, Hkv, _ = k_pool.shape
    if (D * q.element_size()) % 16 or k_pool.data_ptr() % 16 \
            or v_pool.data_ptr() % 16:
        raise ValueError(f"the kernel copies K/V in 16-byte chunks: head "
                         f"dim {D} x {q.element_size()} bytes must be a "
                         f"multiple of 16 and the pools 16-byte aligned")
    scale = D ** -0.5 if scale is None else scale
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, bs, block_table.shape[1], n_blocks,
            float(scale), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError "
                           f"{rc} ({lib.paged_attention_error_string(rc)})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

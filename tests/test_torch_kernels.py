"""The port's paged_attention on CPU tensors (its plain version) against the
JAX package's Pallas kernel in interpret mode and its jnp oracle
(``repro.kernels.ref.paged_attention_ref``), on the same numpy inputs.

Tolerances: float32 at atol = rtol = 1e-5 (the same float32 math summed
in another order). bfloat16: the same bf16 inputs go to every side and
the outputs are compared in float32 at 2e-2 (the port and the Pallas
kernel round their float32 result to bf16, the oracle runs on the inputs
upcast to float32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_plain)
from repro_torch.models.paged_cache import SCRATCH_BLOCK, ZERO_BLOCK

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(*, D, hq, hkv, dtype, bs=8, n_real=3, n_pad=1, seed=0):
    """Five rows over a shared pool: len 1; a full table; a ragged row
    whose table repeats a block id; a pad row pointing only at the
    scratch block; a row repeating another row's blocks. ``n_pad``
    ZERO_BLOCK columns pad every row past its length."""
    rng = np.random.default_rng(seed)
    n_blocks = 2 + 3 * n_real
    q = rng.standard_normal((5, hq, D)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, bs, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, hkv, D)).astype(np.float32)
    kp[ZERO_BLOCK] = vp[ZERO_BLOCK] = 0.0
    ids = rng.permutation(np.arange(2, n_blocks))
    real = np.stack([ids[:n_real], ids[n_real:2 * n_real],
                     ids[2 * n_real:3 * n_real],
                     np.full(n_real, SCRATCH_BLOCK), ids[n_real:2 * n_real]])
    real[2, 1] = real[2, 0]                     # repeated id within a row
    table = np.concatenate(
        [real, np.full((5, n_pad), ZERO_BLOCK)], axis=1).astype(np.int32)
    full = n_real * bs
    lens = np.array([1, full, int(rng.integers(bs + 1, full)), full - 3,
                     int(rng.integers(2, bs))], np.int32)
    return q, kp, vp, table, lens


def _port(q, kp, vp, table, lens, dtype):
    t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    out = paged_attention(t(q), t(kp), t(vp), torch.from_numpy(table),
                          torch.from_numpy(lens))
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy()


def _jax(q, kp, vp, table, lens, dtype):
    j = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
    pallas = jax_paged_attention(j(q), j(kp), j(vp), jnp.asarray(table),
                                 jnp.asarray(lens), interpret=True)
    up = lambda a: j(a).astype(jnp.float32)  # noqa: E731
    oracle = ref.paged_attention_ref(up(q), up(kp), up(vp), jnp.asarray(table),
                                     jnp.asarray(lens))
    return (np.asarray(pallas.astype(jnp.float32)),
            np.asarray(oracle, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_paged_attention_matches_pallas_and_ref(D, g, dtype):
    case = _case(D=D, hq=2 * g, hkv=2, dtype=dtype, seed=D + g)
    out = _port(*case, dtype)
    pallas, oracle = _jax(*case, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(out, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(out, oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_full_table_without_padding(dtype):
    case = _case(D=64, hq=4, hkv=2, dtype=dtype, bs=16, n_real=2, n_pad=0,
                 seed=5)
    q, kp, vp, table, lens = case
    lens[:] = table.shape[1] * 16               # every slot of every row
    out = _port(*case, dtype)
    pallas, oracle = _jax(*case, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(out, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(out, oracle, rtol=tol, atol=tol)


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in _case(
        D=64, hq=4, hkv=2, dtype="float32"))
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, table, lens)
    assert torch.equal(out, paged_attention_plain(q, kp, vp, table, lens))
    assert paged_attention.launches == before


@pytest.mark.parametrize("bad", ["dtype", "table_dtype", "contiguity",
                                 "shape", "device"])
def test_paged_attention_rejects_what_the_kernel_does_not_take(bad):
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in _case(
        D=64, hq=4, hkv=2, dtype="float32"))
    if bad == "dtype":
        q = q.half()
    elif bad == "table_dtype":
        table = table.long()
    elif bad == "contiguity":
        kp = kp.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "shape":
        q = q[:, :3]
    else:
        # neither cpu nor cuda: no plain fallback, the call raises
        q, kp, vp, table, lens = (t.to("meta") for t in (q, kp, vp, table,
                                                         lens))
    with pytest.raises((TypeError, ValueError)):
        paged_attention(q, kp, vp, table, lens)

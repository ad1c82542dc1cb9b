"""The port's CUDA kernel on the card against its plain version, and the
engine on the card against the engine on the CPU. Needs an NVIDIA card
and nvcc (a CUDA kernel has no CPU mode); skips elsewhere. This file
imports no jax, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_to
from repro_torch.configs import get_reduced_config
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_plain)
from repro_torch.models.model import init_params
from repro_torch.models.paged_cache import SCRATCH_BLOCK, ZERO_BLOCK
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import SchedulerConfig

pytestmark = pytest.mark.cuda

# (atol, rtol) of kernel vs plain on the card: both sum in float32, in
# another order; a bf16 output may then round to the neighbouring value,
# one bf16 ulp, at most 2**-7 of the value
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (5e-5, 2 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(D, hq, hkv, dtype, bs, seed, n_real=3):
    rng = np.random.default_rng(seed)
    B, n_pad = 5, 1
    n_blocks = 2 + B * n_real
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    ids = rng.permutation(np.arange(2, n_blocks))[:B * n_real]
    table = np.concatenate([ids.reshape(B, n_real),
                            np.full((B, n_pad), ZERO_BLOCK)], axis=1)
    table[1] = table[0]                          # rows sharing blocks
    table[2, 1] = table[2, 0]                    # a repeated id in a row
    table[3, :n_real] = SCRATCH_BLOCK            # a pad row
    full = n_real * bs
    lens = [1, full, full - 1, bs + 2, 2]
    return (f(B, hq, D), f(n_blocks, bs, hkv, D), f(n_blocks, bs, hkv, D),
            torch.from_numpy(table.astype(np.int32)).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("D,bs", [(16, 8), (64, 16), (128, 16), (256, 64)])
def test_kernel_matches_plain_on_the_card(cuda, D, bs, g, dtype):
    q, kp, vp, table, lens = _case(D, 2 * g, 2, dtype, bs, seed=D + g)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    plain = paged_attention_plain(q, kp, vp, table, lens)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("D,bs,dtype", [
    (128, 16, torch.bfloat16),   # a ring of 4 tiles in shared memory
    (256, 64, torch.bfloat16),   # 3
    (256, 48, torch.float32),    # 2
    (256, 64, torch.float32)])   # 1
def test_kernel_ring_wraps_on_long_tables(cuda, D, bs, dtype):
    """More table columns than ring slots, for every ring depth the
    shared-memory budget picks."""
    q, kp, vp, table, lens = _case(D, 4, 2, dtype, bs, seed=bs, n_real=9)
    out = paged_attention(q, kp, vp, table, lens)
    plain = paged_attention_plain(q, kp, vp, table, lens)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol)


def test_kernel_refuses_rows_it_cannot_copy_in_16_byte_chunks(cuda):
    q, kp, vp, table, lens = _case(8, 4, 2, torch.bfloat16, 8, seed=1)
    q, kp, vp = q[..., :4].contiguous(), kp[..., :4].contiguous(), \
        vp[..., :4].contiguous()             # D = 4: 8-byte rows
    before = paged_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        paged_attention(q, kp, vp, table, lens)
    assert paged_attention.launches == before


def test_engine_on_the_card_matches_the_cpu(cuda):
    cfg = get_reduced_config("qwen3_1_7b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, 8).astype(np.int32), n)
            for n in (8, 2, 2, 2, 5)]
    outs, stats = [], []
    for device, p in (("cuda", params_to(params, "cuda")), ("cpu", params)):
        eng = ServeEngine(cfg, p, device=device, max_batch=4, max_seq=24,
                          scheduler=SchedulerConfig(page_size=8))
        for rid, (prompt, n) in enumerate(reqs):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
        before = paged_attention.launches
        stats.append(eng.run())
        launched = paged_attention.launches - before
        assert launched == (cfg.n_layers * stats[-1]["decode_steps"]
                            if device == "cuda" else 0)
        outs.append({r.rid: r.output for r in eng.done})
    assert outs[0] == outs[1]
    assert stats[0]["slot_steps"] == stats[1]["slot_steps"]
    assert stats[0]["kv_blocks_in_use"] == 0

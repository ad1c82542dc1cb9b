"""The port's ServeEngine(device="cpu") against the JAX ServeEngine on the
same requests, greedy, reduced qwen3 (float32) with the same params:
identical output tokens per request and identical scheduler stats. Plus
the pure-Python halves (BlockAllocator, Scheduler) held op for op
against the JAX package's, and the admission failure path."""
import jax
import numpy as np
import pytest

from repro.configs import get_reduced_config as jax_reduced
from repro.models.model import init_params as jax_init_params
from repro.models.paged_cache import BlockAllocator as JaxAllocator
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch.bridge import to_torch
from repro_torch.configs import get_reduced_config
from repro_torch.models.paged_cache import (RESERVED_BLOCKS, SCRATCH_BLOCK,
                                            BlockAllocator)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import (PagedSlotGroup, Scheduler,
                                         SchedulerConfig, _pow2_at_least)

STATS = ("slot_steps", "kv_blocks_peak", "kv_shared_blocks", "prefills",
         "decode_steps", "prefill_tokens", "requests", "total_new_tokens")


@pytest.fixture(scope="module")
def setup():
    over = dict(n_layers=2, d_model=64, vocab_size=128)
    jcfg = jax_reduced("qwen3_1_7b").with_overrides(**over)
    cfg = get_reduced_config("qwen3_1_7b").with_overrides(**over)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, to_torch(jparams, cfg)


def _cohort(name, vocab):
    rng = np.random.default_rng(11)
    if name == "mixed_max_new":           # tests/test_paged.py:46
        return [(rng.integers(0, vocab, 8), n) for n in (8, 2, 2, 2)]
    if name == "shared_head":             # whole-prompt dedup + prefix share
        head = rng.integers(0, vocab, 16)
        other = head.copy()
        other[-1] ^= 1                    # shares the first full block only
        return [(head, 4), (head, 6), (head, 3), (other, 5)]
    # two prompt lengths, more requests than slots: admission mid-decode
    return [(rng.integers(0, vocab, 8 if i % 3 else 12), 2 + i % 5)
            for i in range(7)]


@pytest.mark.parametrize("cohort", ["mixed_max_new", "shared_head",
                                    "mid_decode_admission"])
def test_engine_matches_jax_engine(setup, cohort):
    jcfg, cfg, jparams, params = setup
    reqs = _cohort(cohort, cfg.vocab_size)
    kw = dict(max_batch=4, max_seq=24)
    jeng = JaxEngine(jcfg, jparams, scheduler=JaxSchedulerConfig(
        kv_layout="paged", page_size=8), **kw)
    eng = ServeEngine(cfg, params, device="cpu",
                      scheduler=SchedulerConfig(page_size=8), **kw)
    for rid, (p, n) in enumerate(reqs):
        prompt = np.asarray(p, np.int32)
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    jstats, stats = jeng.run(), eng.run()

    jout = {r.rid: r.output for r in jeng.done}
    out = {r.rid: r.output for r in eng.done}
    assert out == jout
    assert {k: stats[k] for k in STATS} == {k: jstats[k] for k in STATS}
    assert stats["kv_blocks_in_use"] == 0
    if cohort == "shared_head":
        assert stats["kv_shared_blocks"] > 0


def test_block_allocator_matches_jax_op_for_op():
    rng = np.random.default_rng(7)
    ours, theirs = BlockAllocator(12), JaxAllocator(12)
    held = []
    for step in range(400):
        op = rng.integers(0, 5)
        if op == 0 or not held:
            res = []
            for al in (ours, theirs):
                try:
                    res.append(al.alloc())
                except RuntimeError as e:
                    res.append(str(e))
            assert res[0] == res[1]
            if isinstance(res[0], int):
                held.append(res[0])
        elif op == 1:
            bid = held[rng.integers(len(held))]
            ours.incref(bid, shared=bool(step % 2))
            theirs.incref(bid, shared=bool(step % 2))
            held.append(bid)
        elif op == 2:
            bid = held.pop(rng.integers(len(held)))
            ours.decref(bid)
            theirs.decref(bid)
        elif op == 3:
            key = int(rng.integers(4))
            assert ours.share(key) == theirs.share(key)
            bid = held[rng.integers(len(held))]
            ours.publish(key, bid)
            theirs.publish(key, bid)
        else:
            ours.reset_stats()
            theirs.reset_stats()
        for attr in ("blocks_in_use", "blocks_free", "peak_blocks",
                     "shared_hits"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        assert [ours.refcount(b) for b in range(12)] == \
            [theirs.refcount(b) for b in range(12)]


@pytest.mark.parametrize("policy", ["bucketed", "fifo"])
def test_scheduler_admits_like_jax(policy):
    rng = np.random.default_rng(9)
    ours = Scheduler(SchedulerConfig(policy=policy))
    theirs = JaxScheduler(JaxSchedulerConfig(policy=policy))
    for rid in range(40):
        r = Request(rid=rid, prompt=np.zeros(int(rng.choice([4, 8, 12])),
                                             np.int32),
                    max_new_tokens=int(rng.integers(1, 9)))
        ours.submit(r)
        theirs.submit(r)
        if rid % 3 == 2:
            free = int(rng.integers(0, 6))
            assert [x.rid for x in ours.select(free)] == \
                [x.rid for x in theirs.select(free)]
    assert [r.rid for r in ours.pending] == [r.rid for r in theirs.pending]


def test_admission_failure_returns_every_block(setup):
    """Pool exhaustion while the cohort's tables are being built: every
    block already taken is decref'd, so the pool drains to zero, and the
    cohort goes back to the scheduler."""
    _, cfg, _, params = setup
    eng = ServeEngine(cfg, params, device="cpu", max_batch=4, max_seq=24,
                      scheduler=SchedulerConfig(page_size=8),
                      kv_pool_blocks=RESERVED_BLOCKS + 3)
    rng = np.random.default_rng(6)
    for rid in range(2):                  # 2 prompts x 2 full blocks > 3
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 16).astype(np.int32), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.run()
    assert eng.kv_allocator.blocks_in_use == 0
    assert len(eng.scheduler) == 2 and not eng.groups


def test_paged_compact_is_a_table_row_select():
    class _Req:
        def __init__(self, n):
            self.max_new_tokens, self.output = n, []
    import torch
    al = BlockAllocator(RESERVED_BLOCKS + 16)
    reqs = [_Req(4), _Req(0), _Req(0), _Req(4)]
    table = np.array([[al.alloc(), al.alloc()] for _ in range(4)], np.int32)
    g = PagedSlotGroup(reqs, table, cur=torch.arange(4)[:, None], plen=4,
                       allocator=al, block_size=4, pos=4)
    assert g.compact("pow2") == 2
    assert g.width == 2 and al.blocks_in_use == 4
    assert g.cur[:, 0].tolist() == [0, 3]
    g.requests[1].output = [0] * 4        # last row finishes
    assert g.compact("pow2") == 1         # 1 active -> width 1
    assert al.blocks_in_use == 2 and g.table.shape == (1, 2)
    g.requests = [None]
    assert g.compact("exact") == 1 and al.blocks_in_use == 0
    assert [_pow2_at_least(n) for n in (0, 1, 2, 3, 5)] == [0, 1, 2, 4, 8]


def test_pad_rows_point_at_the_scratch_block():
    class _Req:
        def __init__(self, n):
            self.max_new_tokens, self.output = n, []
    import torch
    al = BlockAllocator(RESERVED_BLOCKS + 16)
    reqs = [_Req(4), _Req(4), _Req(4), _Req(0)]
    table = np.array([[al.alloc()] for _ in range(4)], np.int32)
    g = PagedSlotGroup(reqs, table, cur=torch.zeros(4, 1, dtype=torch.long),
                       plen=4, allocator=al, block_size=4, pos=4)
    assert g.compact("pow2") == 0         # 3 active: pow2 width stays 4
    reqs[2].output = [0] * 4
    assert g.compact("pow2") == 2         # 2 active -> width 2, no pad
    g.requests = [reqs[0], None]          # one active of width 2, pad row
    g.ensure_frontier()                   # pos 4 = column 1
    assert g.table[1, 1] == SCRATCH_BLOCK and g.table[0, 1] >= RESERVED_BLOCKS
    dev = g.device_table(torch.device("cpu"))
    assert dev.dtype == torch.int32 and tuple(dev.shape) == (2, 2)


@pytest.mark.parametrize("bad", [dict(policy="wave"),
                                 dict(kv_layout="contiguous"),
                                 dict(prefill_chunk=16), dict(debug_kv=True)])
def test_later_slice_options_raise(bad):
    with pytest.raises(ValueError, match="slice"):
        SchedulerConfig(**bad)


@pytest.mark.parametrize("kw", ["measurements", "faults", "straggler"])
def test_later_slice_engine_arguments_raise(setup, kw):
    _, cfg, _, params = setup
    with pytest.raises(NotImplementedError, match="slice"):
        ServeEngine(cfg, params, device="cpu", **{kw: object()})
    with pytest.raises(NotImplementedError, match="slice"):
        ServeEngine.from_artifact("artifact-dir")

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card
and check it. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed as JSON lines (any failure raises, and the script
exits non-zero without printing a result):

1. device  — the card's name and power limit (``nvidia-smi``), then the
   kernel build from ``src/repro_torch/kernels/csrc`` with its time and
   ptxas register and spill lines.
2. kernels — each kernel against its plain PyTorch version on the card,
   in bfloat16 and float32, at the serving path's shapes and on one long
   context; CUDA-event times with the L2 cache flushed between calls, the
   bound (bytes at 3.35 TB/s, operations at the type's peak), and one
   PyTorch library call on the same inputs as a yardstick.
3. serve   — ``qwen3_1_7b`` at full width, bfloat16, random weights from
   a seeded generator, serving the launcher's 8 requests through
   ``repro_torch.launch.serve``. Kernel launch counts are set to 0 just
   before that run and read just after. A second, warm run gives the
   timings; a third, under ``torch.profiler``, the device busy time.
4. parity  — reduced qwen3 in float32 gives the same greedy tokens and
   scheduler stats on the card (kernel) and on the CPU (plain version).
5. one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12,      # dense bf16 tensor cores
                  "float32": 67e12}        # float32 outside the tensor cores
# (atol, rtol) of kernel vs plain. Both compute in float32 and differ
# there only by summation order (~1e-5 at most); a bfloat16 output then
# rounds each to a neighbouring value at worst, one bf16 ulp, which is at
# most 2**-7 of the value.
TOL = {"bfloat16": (5e-5, 2 ** -7), "float32": (1e-5, 1e-5)}
TIMED_CALLS = 50


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, flush, calls=TIMED_CALLS):
    """Median CUDA-event time of ``fn`` over ``calls`` launches, the L2
    cache flushed (a 256 MB write) before each."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(calls):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def warm_up_card(torch, seconds=1.0):
    """Bring the card's clocks up before the first timing."""
    x = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            x = torch.tanh(x @ x)
        torch.cuda.synchronize()


def paged_case(torch, np, *, B, Hq, Hkv, D, bs, n_cols, lens, dtype, seed,
               dev="cuda"):
    """Pools and a table as the engine builds them: each row's blocks
    for its length, rows 0 and 1 sharing their first blocks (a shared
    prompt head), the last row a pad row on the scratch block, and
    ZERO_BLOCK in every column past a row's length."""
    from repro_torch.models.paged_cache import SCRATCH_BLOCK, ZERO_BLOCK
    rng = np.random.default_rng(seed)
    n_blocks = 2 + B * n_cols
    table = np.full((B, n_cols), ZERO_BLOCK, np.int32)
    ids = iter(rng.permutation(np.arange(2, n_blocks)))
    for b, n in enumerate(lens):
        for c in range(-(-n // bs)):
            table[b, c] = next(ids)
    shared = min(-(-lens[0] // bs), -(-lens[1] // bs)) - 1
    table[1, :shared] = table[0, :shared]
    table[B - 1, :-(-lens[B - 1] // bs)] = SCRATCH_BLOCK
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(dev, getattr(torch, dtype))
    return (mk(B, Hq, D), mk(n_blocks, bs, Hkv, D), mk(n_blocks, bs, Hkv, D),
            torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def paged_bound(q, k_pool, table, lens, dtype):
    """Least time for the work these inputs need: q and the output once;
    each K/V position some row needs (a (block id, offset) pair below that
    row's length) once, however many rows or columns share it; the table
    entries walked and the lengths. Operations: 4·D per (query head, key
    of a row)."""
    B, Hq, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    isz = q.element_size()
    tab, row_lens = table.cpu().tolist(), lens.cpu().tolist()
    needed, n_entries = set(), 0
    for row, n in zip(tab, row_lens):
        n_entries += -(-n // bs)
        for c in range(-(-n // bs)):
            needed.update((row[c], o) for o in range(min(bs, n - c * bs)))
    nbytes = 2 * q.numel() * isz + 2 * len(needed) * Hkv * D * isz \
        + 4 * n_entries + 4 * B
    ops = 4 * Hq * D * sum(row_lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, len(needed))


def kernel_phase(torch, np, flush):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    serve_lens = [48, 48, 33, 40, 47, 17, 1, 48]
    cases = {"serve": dict(B=8, Hq=16, Hkv=8, D=128, bs=16, n_cols=4,
                           lens=serve_lens),
             "long": dict(B=8, Hq=16, Hkv=8, D=128, bs=16, n_cols=128,
                          lens=[2000, 2000, 1993, 1950, 2047, 1800, 2011,
                                2000])}
    results = {}
    warm_up_card(torch)
    for name, shape in cases.items():
        for dtype in ("bfloat16", "float32"):
            q, kp, vp, table, lens = paged_case(torch, np, dtype=dtype,
                                                seed=len(results), **shape)
            out = paged_attention(q, kp, vp, table, lens)
            torch.cuda.synchronize()
            plain = paged_attention_plain(q, kp, vp, table, lens)
            err = (out.float() - plain.float()).abs()
            atol, rtol = TOL[dtype]
            share = err / (atol + rtol * plain.float().abs())
            ok = bool((share <= 1).all())
            max_err = float(err.max())

            # yardstick: SDPA over K/V gathered and expanded beforehand
            B, Hq, D = q.shape
            S, g = shape["n_cols"] * shape["bs"], Hq // shape["Hkv"]
            idx = table.long()
            kx, vx = (p[idx].reshape(B, S, shape["Hkv"], D).transpose(1, 2)
                      .repeat_interleave(g, dim=1).contiguous()
                      for p in (kp, vp))
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = F.scaled_dot_product_attention(q4, kx, vx, attn_mask=mask)
            lib_err = float((lib[:, :, 0].float() - plain.float()).abs().max())

            bound_ms, bound_by, nbytes, n_pos = paged_bound(q, kp, table,
                                                            lens, dtype)
            ms = cuda_ms(lambda: paged_attention(q, kp, vp, table, lens),
                         flush)
            plain_ms = cuda_ms(
                lambda: paged_attention_plain(q, kp, vp, table, lens), flush,
                calls=10)
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, kx, vx,
                                                       attn_mask=mask), flush)
            row = {"kernel": "paged_attention", "case": name, "dtype": dtype,
                   "shape": {k: v for k, v in shape.items() if k != "lens"},
                   "lens": shape["lens"], "max_abs_err": max_err,
                   "atol": atol, "rtol": rtol,
                   "max_err_share_of_limit": float(share.max()), "ok": ok, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_max_abs_err": lib_err,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": nbytes, "distinct_kv_positions": n_pos,
                   "achieved_gb_s": nbytes / ms / 1e6,
                   "ms_over_bound": ms / bound_ms}
            emit("kernels", **row)
            if not ok:
                raise AssertionError(f"paged_attention disagrees with its "
                                     f"plain version: {row}")
            results[(name, dtype)] = row
    return results


def profile_serve(torch, eng, args, serve):
    """Device busy time of one serve run under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    eng.reset_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(eng, args)
        torch.cuda.synchronize()
    kernels = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(us for _, us, _ in kernels)
    top = sorted(kernels, key=lambda t: -t[1])[:10]
    pa_us = sum(us for k, us, _ in kernels if "paged_attention" in k)
    return busy_us / 1e6, pa_us / 1e6, [
        {"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
        for k, us, n in top]


def serve_phase(torch, np):
    from repro_torch.bridge import leaves
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch import serve as launch_serve

    args = launch_serve.parser().parse_args([])   # the launcher's defaults
    t0 = time.perf_counter()
    eng = launch_serve.build_engine(args)
    torch.cuda.synchronize()
    cfg = eng.cfg
    n_params = sum(t.numel() for t in leaves(eng.params))
    emit("serve", model=cfg.name, dtype=cfg.dtype, n_layers=cfg.n_layers,
         d_model=cfg.d_model, params=n_params,
         init_s=time.perf_counter() - t0)

    # logits must be finite on every live row (checked in the counted run)
    sample = eng._sample
    nonfinite = []

    def checked_sample(logits, rows):
        live = [i for i, r in enumerate(rows) if r is not None]
        nonfinite.append(int((~torch.isfinite(logits[live])).sum()))
        return sample(logits, rows)

    eng._sample = checked_sample
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    reqs, stats = launch_serve.serve(eng, args)
    launches = paged_attention.launches
    eng._sample = sample
    expected = cfg.n_layers * stats["decode_steps"]
    checks = {
        "all_finished": stats["requests"] == args.requests and all(
            r.done and len(r.output) == args.max_new for r in reqs),
        "logits_finite": sum(nonfinite) == 0,
        "pool_drained": stats["kv_blocks_in_use"] == 0,
        "launches_equal_layers_x_steps": launches == expected,
    }
    emit("serve", run="counted", launches=launches, expected=expected,
         nonfinite_logits=sum(nonfinite), checks=checks,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), stats=stats)
    if not all(checks.values()):
        raise AssertionError(f"serve phase failed its checks: {checks}")

    eng.reset_stats()
    _, warm = launch_serve.serve(eng, args)
    busy_s, pa_s, top = profile_serve(torch, eng, args, launch_serve.serve)
    emit("serve", run="warm", stats=warm)
    emit("serve", run="profiled", device_busy_s=busy_s,
         paged_attention_device_s=pa_s,
         device_idle_share=(1.0 - busy_s / warm["wall_s"]) if busy_s else None,
         idle_share_note="1 - device busy time (profiled run) / wall time "
                         "of the unprofiled warm run of the same requests",
         top_kernels=top)
    return launches


def parity_phase(torch, np):
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import SchedulerConfig

    cfg = get_reduced_config("qwen3_1_7b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab_size, 16)
    other = head.copy()
    other[-1] ^= 1
    cohorts = ([(rng.integers(0, cfg.vocab_size, 8), n) for n in (8, 2, 2, 2)]
               + [(head, 6), (head, 4), (other, 5)]
               + [(rng.integers(0, cfg.vocab_size, 12), 5) for _ in range(2)])

    def run(device):
        p = params_to(params, device)
        eng = ServeEngine(cfg, p, device=device, max_batch=4, max_seq=32,
                          scheduler=SchedulerConfig(page_size=8))
        for rid, (prompt, n) in enumerate(cohorts):
            eng.submit(Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                               max_new_tokens=n))
        before = paged_attention.launches
        stats = eng.run()
        out = {r.rid: r.output for r in eng.done}
        return out, stats, paged_attention.launches - before

    out_cuda, s_cuda, n_cuda = run("cuda")
    out_cpu, s_cpu, n_cpu = run("cpu")
    keys = ("slot_steps", "kv_blocks_peak", "kv_shared_blocks", "prefills",
            "decode_steps", "kv_blocks_in_use")
    differing = sorted(r for r in out_cpu if out_cpu[r] != out_cuda.get(r))
    checks = {
        "identical_tokens": not differing and set(out_cpu) == set(out_cuda),
        "identical_stats": all(s_cpu[k] == s_cuda[k] for k in keys),
        "cuda_used_kernel": n_cuda == cfg.n_layers * s_cuda["decode_steps"],
        "cpu_used_plain": n_cpu == 0,
    }
    emit("parity", model=cfg.name, dtype=cfg.dtype, requests=len(cohorts),
         differing_requests=differing, checks=checks,
         stats={k: [s_cpu[k], s_cuda[k]] for k in keys},
         launches={"cuda": n_cuda, "cpu": n_cpu})
    if not all(checks.values()):
        raise AssertionError(f"parity phase failed its checks: {checks}")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs an "
                 "NVIDIA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import REPLACES, SOURCE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = build.build()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         build_wall_s=time.perf_counter() - t0, build=built)

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    kernel_rows = kernel_phase(torch, np, flush)
    del flush
    launches = serve_phase(torch, np)
    parity_phase(torch, np)

    emit("done", total_s=time.perf_counter() - t_start)
    row = kernel_rows[("serve", "bfloat16")]
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

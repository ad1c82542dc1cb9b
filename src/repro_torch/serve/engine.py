"""Serving engine (port of ``repro/serve/engine.py``): prefill + paged
decode behind the stepped scheduler core.

* a global budget of ``max_batch`` decode slots, shared by every live
  :class:`~repro_torch.serve.scheduler.PagedSlotGroup` (one admitted
  cohort of equal-length prompts mid-decode);
* :meth:`ServeEngine.step` runs one scheduling quantum (admit one
  cohort, or advance every live group one token); :meth:`serve_forever`
  loops it, :meth:`run` drains;
* KV lives in one block pool for all layers; admission prefills each
  distinct prompt once and shares full prefix blocks copy-on-write;
  finished rows free their slots mid-decode (table row-select, no copy);
* sampling is greedy or temperature (Gumbel-max from the engine's own
  ``torch.Generator``), per request.

A decode step makes one host sync: reading the sampled tokens back. The
block table and other host data reach the card as non-blocking copies
from pinned memory, and positions are filled on the device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.bridge import leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.paged_cache import (RESERVED_BLOCKS, BlockAllocator,
                                            init_paged_pools,
                                            scatter_prefill_blocks)
from repro_torch.serve.scheduler import (PagedSlotGroup, Scheduler,
                                         SchedulerConfig)
from repro_torch.util import resolve_device, to_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


class ServeEngine:
    """The stepped serving engine on ``device`` (``"cuda"`` unless the
    caller asks for ``"cpu"``, which runs the kernels' plain versions).
    ``params`` must already live on that device."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_seq: int = 512, seed: int = 0, device="cuda",
                 scheduler: Union[SchedulerConfig, str, None] = None,
                 kv_pool_blocks: Optional[int] = None,
                 measurements=None, faults=None, straggler=None):
        for name, value in (("measurements", measurements),
                            ("faults", faults), ("straggler", straggler)):
            if value is not None:
                raise NotImplementedError(
                    f"{name}= waits for the slice that ports "
                    f"repro.core.oracle and repro.util.faults")
        self.device = resolve_device(device)
        off = {str(t.device) for t in leaves(params)
               if t.device.type != self.device.type}
        if off:
            raise ValueError(f"params lie on {sorted(off)}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.model = Model(cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        if scheduler is None:
            scheduler = SchedulerConfig()
        elif isinstance(scheduler, str):
            scheduler = SchedulerConfig(policy=scheduler)
        self.scheduler = Scheduler(scheduler)
        self.groups: List[PagedSlotGroup] = []
        self.done: List[Request] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        bs = scheduler.page_size
        n_blocks = kv_pool_blocks if kv_pool_blocks is not None else \
            RESERVED_BLOCKS + max_batch * (-(-max_seq // bs))
        self.kv_allocator = BlockAllocator(n_blocks)
        self._pools = init_paged_pools(self.model, n_blocks, bs, self.device)
        # bytes one token position costs across every layer's K+V
        self._kv_row_bytes = (cfg.n_layers * 2 * cfg.n_kv_heads
                              * cfg.head_dim * self._pools.k.element_size())
        self.reset_stats()

    @classmethod
    def from_artifact(cls, *args, **kwargs):
        raise NotImplementedError("serving a DeploymentArtifact waits for "
                                  "the slice that ports repro.api")

    # -- queueing -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if not req.t_submit:
            req.t_submit = time.time()
        self.scheduler.submit(req)

    # -- the stepped core ---------------------------------------------------

    def step(self) -> Dict[str, Any]:
        """One non-blocking scheduling quantum: admit one cohort (prefill
        + first sampled token) when the scheduler yields one for the free
        slots; otherwise advance every live group one decode token;
        otherwise report ``idle``."""
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                return self._step_inner()
        finally:
            self._wall_s += time.perf_counter() - t0

    def _step_inner(self) -> Dict[str, Any]:
        free = self.max_batch - sum(g.width for g in self.groups)
        batch = self.scheduler.select(free)
        if batch:
            try:
                self._admit_paged(batch)
            except Exception:
                # the scheduler already popped the cohort: hand it back
                # before propagating, so no request is lost
                for r in batch:
                    self.scheduler.submit(r)
                raise
            return {"event": "prefill", "admitted": len(batch),
                    "prompt_len": len(batch[0].prompt),
                    "live_groups": len(self.groups)}
        if self.groups:
            return {"event": "decode", "live_groups": len(self.groups),
                    "new_tokens": self._decode_tick()}
        return {"event": "idle", "pending": len(self.scheduler)}

    def serve_forever(self, deadline_s: Optional[float] = None
                      ) -> Dict[str, Any]:
        """Step until drained, or until ``deadline_s`` wall seconds pass
        (resumable: pending requests and live groups stay). Returns
        :meth:`stats`."""
        t0 = time.time()
        while deadline_s is None or time.time() - t0 < deadline_s:
            if self.step()["event"] == "idle":
                break
        return self.stats()

    def run(self) -> Dict[str, Any]:
        """Blocking drain."""
        return self.serve_forever()

    # -- admission + decode -------------------------------------------------

    def _admit_paged(self, reqs: List[Request]) -> PagedSlotGroup:
        """Prefill each *distinct* prompt once at the cohort's
        block-padded length, copy whole KV blocks into the pools, and
        point every row's block table at them — full prefix blocks shared
        (refcounted) across identical prompt heads, the partial frontier
        block always private per row."""
        sc = self.scheduler.config
        bs = sc.page_size
        plen = len(reqs[0].prompt)
        W = len(reqs)
        alloc = self.kv_allocator
        prompts = [np.asarray(r.prompt, np.int32) for r in reqs]
        share = sc.share_prefix
        if share:
            # whole-prompt dedup within the cohort: prefill unique rows
            # only, fan the last-token logits back out per request
            uniq: Dict[bytes, int] = {}
            u_prompts: List[np.ndarray] = []
            row_to_u: List[int] = []
            for p in prompts:
                kb = p.tobytes()
                if kb not in uniq:
                    uniq[kb] = len(u_prompts)
                    u_prompts.append(p)
                row_to_u.append(uniq[kb])
        else:
            u_prompts, row_to_u = prompts, list(range(W))
        U = len(u_prompts)
        padded = -(-plen // bs) * bs
        ncb = padded // bs
        # logits come from the true last position; only the returned
        # cache is block-padded (its slots past plen sit at positions the
        # causal mask hides until decode overwrites them)
        logits_u, caches = self.model.prefill(
            self.params, to_device(np.stack(u_prompts), self.device,
                                   np.int64), padded)

        rows_s: List[int] = []   # copy worklist out of the U prefill rows
        cols_s: List[int] = []
        bids_s: List[int] = []
        # every reference acquired below, in order: pool exhaustion
        # mid-table returns them all before the cohort is re-queued, or
        # the pool would shrink for good
        acquired: List[int] = []
        u_tables = np.zeros((U, ncb), np.int32)
        try:
            for u, p in enumerate(u_prompts):
                for j in range(ncb):
                    full = (j + 1) * bs <= plen
                    if share and full:
                        # plen and U are part of the key: k/v bits can
                        # differ across padded lengths / batch widths, and
                        # a shared block must be one computation
                        key = (plen, U, p[:(j + 1) * bs].tobytes())
                        bid = alloc.share(key)
                        if bid is not None:
                            acquired.append(bid)
                        else:
                            bid = alloc.alloc()
                            acquired.append(bid)
                            alloc.publish(key, bid)
                            rows_s.append(u); cols_s.append(j)
                            bids_s.append(bid)
                    else:
                        bid = alloc.alloc()
                        acquired.append(bid)
                        rows_s.append(u); cols_s.append(j); bids_s.append(bid)
                    u_tables[u, j] = bid
            table = np.zeros((W, ncb), np.int32)
            seen_u: Dict[int, int] = {}
            frontier = ncb - 1 if plen % bs else None
            for i in range(W):
                u = row_to_u[i]
                if u not in seen_u:
                    seen_u[u] = i
                    table[i] = u_tables[u]
                    continue
                for j in range(ncb):
                    if j == frontier:
                        bid = alloc.alloc()  # private frontier per duplicate
                        acquired.append(bid)
                        rows_s.append(u); cols_s.append(j); bids_s.append(bid)
                    else:
                        bid = int(u_tables[u, j])
                        alloc.incref(bid, shared=True)
                        acquired.append(bid)
                    table[i, j] = bid
        except BaseException:
            for bid in reversed(acquired):
                alloc.decref(bid)
            raise
        scatter_prefill_blocks(self._pools, caches, rows_s, cols_s, bids_s,
                               block_size=bs)

        logits = logits_u if U == W else logits_u[
            to_device(row_to_u, self.device, np.int64)]
        cur, toks = self._sample(logits, reqs)
        t_first = time.time()
        for r, t in zip(reqs, toks):
            r.t_first_token = t_first
            r.output.append(t)
        self._prefills += 1
        self._prefill_tokens += U * plen
        group = PagedSlotGroup(reqs, table, cur, plen, allocator=alloc,
                               block_size=bs, pos=plen)
        self.groups.append(group)
        self._retire(group)
        return group

    def _decode_tick(self) -> int:
        new_tokens = 0
        self._ticks += 1
        for group in list(self.groups):
            t0 = time.perf_counter()
            if group.pos % group.block_size == 0:
                # decode is about to cross into a new block-table column
                group.ensure_frontier()
            logits = self.model.decode_step_paged(
                self.params, group.cur, self._pools,
                group.device_table(self.device), group.pos)
            group.pos += 1
            group.cur, toks = self._sample(logits, group.requests)
            dt = time.perf_counter() - t0   # ends when tokens reach the host
            self._decode_wall_s += dt
            self._step_times.append(dt)
            self._decode_steps += 1
            self._slot_steps += group.width
            self._active_slot_steps += sum(
                1 for r in group.requests if r is not None)
            for r, t in zip(group.requests, toks):
                if r is not None and len(r.output) < r.max_new_tokens:
                    r.output.append(t)
                    new_tokens += 1
            self._retire(group)
        return new_tokens

    def _retire(self, group: PagedSlotGroup) -> None:
        """Move finished requests out of their rows, drop the group when
        empty, and compact the surviving rows (freed slots return to the
        global budget, so the next cohort can be admitted mid-decode)."""
        now = time.time()
        for i, r in enumerate(group.requests):
            if r is not None and len(r.output) >= r.max_new_tokens:
                r.done, r.t_done = True, now
                self.done.append(r)
                group.requests[i] = None
        if all(r is None for r in group.requests):
            self.groups.remove(group)
            group.release()   # refcounts drop; orphaned blocks free
            return
        group.compact(self.scheduler.config.compact)

    def _sample(self, logits: torch.Tensor, rows: List[Optional[Request]]
                ) -> Tuple[torch.Tensor, List[int]]:
        """Next token per row: argmax, or Gumbel-max over
        ``logits / temperature`` where the row's temperature is > 0.
        Returns the tokens as a (W, 1) device tensor and as host ints —
        reading them back is the step's one host sync."""
        last = logits[:, 0].float()
        tok = last.argmax(dim=-1)
        temps = np.asarray([r.temperature if r is not None else 0.0
                            for r in rows], np.float32)
        if (temps > 0).any():
            t = to_device(temps, self.device)[:, None]
            u = torch.rand(last.shape, generator=self.generator,
                           device=self.device).clamp_min_(1e-20)
            noisy = (last / t.clamp_min(1e-6) - torch.log(-torch.log(u))
                     ).argmax(dim=-1)
            tok = torch.where(t[:, 0] > 0, noisy, tok)
        return tok[:, None], tok.tolist()

    # -- stats ---------------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero every counter and forget retired requests (their Request
        objects keep their outputs)."""
        self.done = []
        self._prefills = 0
        self._ticks = 0
        self._decode_steps = 0
        self._decode_wall_s = 0.0
        self._slot_steps = 0
        self._active_slot_steps = 0
        self._step_times: List[float] = []
        self._wall_s = 0.0
        self._prefill_tokens = 0
        self.kv_allocator.reset_stats()

    @staticmethod
    def _pct(xs: List[float], q: float) -> float:
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    def stats(self) -> Dict[str, Any]:
        total_tokens = sum(len(r.output) for r in self.done)
        ttfts = [r.t_first_token - r.t_submit for r in self.done]
        decodes = [r.t_done - r.t_first_token for r in self.done]
        alloc = self.kv_allocator
        return {
            "device": str(self.device),
            "requests": len(self.done),
            "prefills": self._prefills,
            "total_new_tokens": total_tokens,
            "wall_s": self._wall_s,
            "tokens_per_s": total_tokens / max(self._wall_s, 1e-9),
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "p50_ttft_s": self._pct(ttfts, 50),
            "p95_ttft_s": self._pct(ttfts, 95),
            "p50_decode_s": self._pct(decodes, 50),
            "p95_decode_s": self._pct(decodes, 95),
            "p50_step_s": self._pct(self._step_times, 50),
            "p95_step_s": self._pct(self._step_times, 95),
            # decode_steps counts model decode calls (one per live group
            # per tick), slot_steps the batch rows they carried,
            # active_slot_steps the rows doing useful work
            "decode_steps": self._decode_steps,
            "decode_ticks": self._ticks,
            "slot_steps": self._slot_steps,
            "active_slot_steps": self._active_slot_steps,
            "mean_batch_occupancy": (
                self._active_slot_steps / (self._ticks * self.max_batch)
                if self._ticks else 0.0),
            "measured_step_s": (self._decode_wall_s / self._decode_steps
                                if self._decode_steps else 0.0),
            "kv_layout": "paged",
            "prefill_tokens": self._prefill_tokens,
            "kv_blocks_peak": alloc.peak_blocks,
            "kv_blocks_in_use": alloc.blocks_in_use,
            "kv_shared_blocks": alloc.shared_hits,
            "peak_kv_bytes": (alloc.peak_blocks
                              * self.scheduler.config.page_size
                              * self._kv_row_bytes),
        }

"""Scheduler core for the serving engine (port of
``repro/serve/scheduler.py``): admission and slot bookkeeping.

``Scheduler`` keeps pending requests in prompt-length buckets (prefill
needs equal lengths) and admits the bucket that fills the free slots
best, ordered by ``max_new_tokens`` so a cohort finishes together.
``PagedSlotGroup`` is one admitted cohort mid-decode: its requests, its
host-side block table, and the current token per row. Groups shrink as
requests finish — compaction is a row-select on the table plus decrefs,
with zero K/V copies.

This slice serves the paged layout with the ``bucketed`` and ``fifo``
policies and without chunked prefill; the contiguous layout, the
``wave`` policy and ``prefill_chunk`` come with a later slice.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.paged_cache import RESERVED_BLOCKS, SCRATCH_BLOCK
from repro_torch.util import to_device

POLICIES = ("bucketed", "fifo")
COMPACTION = ("pow2", "exact", "off")

@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission + compaction policy for the serving engine.

    ``policy``: ``bucketed`` (default) — fullest prompt-length bucket
    first, requests inside a bucket grouped by ``max_new_tokens``;
    ``fifo`` — the oldest pending request's bucket, in arrival order.
    Both admit mid-decode of other groups.

    ``compact``: ``pow2`` (default) shrinks a group's rows to the next
    power of two once that halves the batch; ``exact`` to the exact
    active count on every finish; ``off`` never.

    ``share_prefix``: reuse full prefix blocks (and the prefill compute)
    across identical prompt heads. ``page_size``: tokens per KV block.

    ``kv_layout="contiguous"``, ``policy="wave"``, ``prefill_chunk > 0``
    and ``debug_kv`` are the JAX engine's and raise here until a later
    slice ports them.
    """

    policy: str = "bucketed"
    compact: str = "pow2"
    kv_layout: str = "paged"
    share_prefix: bool = True
    page_size: int = 16
    prefill_chunk: int = 0
    debug_kv: bool = False

    def __post_init__(self):
        if self.policy == "wave" or self.kv_layout == "contiguous" \
                or self.prefill_chunk:
            raise ValueError(
                f"policy={self.policy!r}, kv_layout={self.kv_layout!r}, "
                f"prefill_chunk={self.prefill_chunk}: the wave policy, the "
                f"contiguous layout and chunked prefill wait for the slice "
                f"that ports flash_attention")
        if self.debug_kv:
            raise ValueError("debug_kv waits for the slice that ports "
                             "repro.analysis (the paged-KV sanitizer)")
        if self.policy not in POLICIES:
            raise ValueError(f"unknown scheduler policy {self.policy!r}; "
                             f"policies: {list(POLICIES)}")
        if self.compact not in COMPACTION:
            raise ValueError(f"unknown compaction mode {self.compact!r}; "
                             f"modes: {list(COMPACTION)}")
        if self.kv_layout != "paged":
            raise ValueError(f"unknown kv layout {self.kv_layout!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1 (got {self.page_size})")


class Scheduler:
    """Prompt-length-bucketed admission over pending requests.

    The engine asks :meth:`select` for the next cohort each step; the
    scheduler answers with a list of equal-prompt-length requests sized
    to the free slots (or ``[]`` when nothing should be admitted yet).
    """

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()
        self._buckets: Dict[int, Deque[Tuple[int, Any]]] = {}
        self._arrival = itertools.count()

    def __len__(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    @property
    def pending(self) -> List[Any]:
        """All pending requests in arrival order (read-only snapshot)."""
        flat = [t for b in self._buckets.values() for t in b]
        return [r for _, r in sorted(flat, key=lambda t: t[0])]

    def submit(self, req) -> None:
        plen = len(req.prompt)
        self._buckets.setdefault(plen, deque()).append(
            (next(self._arrival), req))

    def _pick_bucket(self, free_slots: int) -> Optional[int]:
        live = {k: b for k, b in self._buckets.items() if b}
        if not live:
            return None
        if self.config.policy == "fifo":
            # head-of-line: the oldest pending request defines the cohort
            return min(live, key=lambda k: live[k][0][0])
        # bucketed: best fill of the free slots; ties go to the oldest head
        return max(live, key=lambda k: (min(len(live[k]), free_slots),
                                        -live[k][0][0]))

    def select(self, free_slots: int) -> List[Any]:
        """Admission decision: up to ``free_slots`` equal-length requests
        for one prefill, or ``[]``."""
        if free_slots <= 0 or not len(self):
            return []
        key = self._pick_bucket(free_slots)
        if key is None:
            return []
        bucket = self._buckets[key]
        take = min(len(bucket), free_slots)
        if self.config.policy == "bucketed":
            # group similar decode lengths so the cohort finishes together
            ordered = sorted(bucket, key=lambda t: (t[1].max_new_tokens,
                                                    t[0]))
            chosen = ordered[:take]
            chosen_ids = {t[0] for t in chosen}
            rest = [t for t in bucket if t[0] not in chosen_ids]
            bucket.clear()
            bucket.extend(rest)
        else:
            chosen = [bucket.popleft() for _ in range(take)]
        return [r for _, r in chosen]


def _pow2_at_least(n: int) -> int:
    if n <= 0:
        return 0  # a zero-active group compacts away entirely, not to width 1
    return 1 if n == 1 else 1 << (n - 1).bit_length()


class SlotGroup:
    """One admitted cohort mid-decode. ``requests[row]`` is the request
    fed by that batch row, or ``None`` for a pad row left by power-of-two
    compaction (its tokens are computed and discarded). ``cur`` is the
    (width, 1) tensor of each row's current token."""

    def __init__(self, requests: List[Any], cur: Optional[torch.Tensor],
                 plen: int):
        self.requests: List[Optional[Any]] = list(requests)
        self.cur = cur
        self.plen = plen

    @property
    def width(self) -> int:
        return len(self.requests)

    @property
    def active_rows(self) -> List[int]:
        return [i for i, r in enumerate(self.requests)
                if r is not None and len(r.output) < r.max_new_tokens]

    @property
    def done(self) -> bool:
        return not self.active_rows


class PagedSlotGroup(SlotGroup):
    """A cohort whose KV lives in pool blocks behind a per-row block
    table. ``table`` is host-side numpy ``(width, n_cols)`` int32 —
    compaction is a row-select on it plus refcount decrefs for blocks
    only the dropped rows referenced. The device copy of the table
    (padded with ``ZERO_BLOCK`` to a power-of-two column count) is cached
    and rebuilt on mutation."""

    def __init__(self, requests: List[Any], table, cur, plen: int, *,
                 allocator, block_size: int, pos: int):
        super().__init__(requests, cur=cur, plen=plen)
        self.table = np.asarray(table, np.int32)
        self.alloc = allocator
        self.block_size = block_size
        self.pos = int(pos)              # next absolute decode position
        self._dev_table: Optional[torch.Tensor] = None
        self._released = False

    def device_table(self, device: torch.device) -> torch.Tensor:
        if self._dev_table is None:
            W, nc = self.table.shape
            ncp = max(1, _pow2_at_least(nc))
            padded = np.zeros((W, ncp), np.int32)  # zero block: masked reads
            padded[:, :nc] = self.table
            self._dev_table = to_device(padded, device)
        return self._dev_table

    def ensure_frontier(self) -> None:
        """Make the table column for ``pos`` writable before a decode
        step lands there: a fresh private block per live row, the scratch
        block for pad rows (their writes are discarded garbage)."""
        col = self.pos // self.block_size
        W, nc = self.table.shape
        changed = False
        if col >= nc:
            self.table = np.concatenate(
                [self.table, np.zeros((W, col + 1 - nc), np.int32)], axis=1)
            changed = True
        for i, r in enumerate(self.requests):
            if self.table[i, col] >= RESERVED_BLOCKS:
                continue
            self.table[i, col] = (self.alloc.alloc() if r is not None
                                  else SCRATCH_BLOCK)
            changed = True
        if changed:
            self._dev_table = None

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        for row in self.table:
            for bid in row:
                if bid >= RESERVED_BLOCKS:
                    self.alloc.decref(int(bid))
        self.table = self.table[:0]
        self._dev_table = None
        self.cur = None

    def compact(self, mode: str) -> int:
        """Shrink the batch to the still-active rows per ``mode``;
        returns the number of slots freed (0 when nothing changed)."""
        if mode == "off":
            return 0
        active = self.active_rows
        if not active:
            freed = self.width
            self.requests = []
            self.release()
            return freed
        target = len(active) if mode == "exact" else _pow2_at_least(
            len(active))
        if target >= self.width:
            return 0
        W, nc = self.table.shape
        keep = set(active)
        for i in range(W):
            if i in keep:
                continue
            for bid in self.table[i]:
                if bid >= RESERVED_BLOCKS:
                    self.alloc.decref(int(bid))
        n_pad = target - len(active)
        # pad rows write (and read back) only scratch garbage; their
        # sampled tokens are discarded with the row
        pad = np.full((n_pad, nc), SCRATCH_BLOCK, np.int32)
        self.table = np.concatenate([self.table[active], pad], axis=0)
        self.requests = [self.requests[i] for i in active] + [None] * n_pad
        rows = active + [active[0]] * n_pad
        self.cur = self.cur[to_device(rows, self.cur.device, np.int64)]
        self._dev_table = None
        return W - target

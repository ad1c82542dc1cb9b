"""Block-paged KV storage for the serving engine (port of
``repro/models/paged_cache.py``).

One pool of fixed-size blocks holds every layer's K/V: block ``b`` of
every layer belongs to the same logical block, so one per-row block table
covers the whole model. Blocks are refcounted; full prompt-prefix blocks
are shared copy-on-write across rows with the same prompt head, and the
partially filled frontier block is always private, so a write never has
to copy.

Two block ids are reserved pool-wide: ``ZERO_BLOCK`` (0) is never
written, and padded table columns point at it (reads are masked by
position); ``SCRATCH_BLOCK`` (1) takes the writes of pad rows left by
power-of-two compaction (their outputs are discarded).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Hashable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN
from repro_torch.util import to_device

#: ids below this are never allocated: 0 = zero/dummy, 1 = pad scratch
RESERVED_BLOCKS = 2
ZERO_BLOCK = 0
SCRATCH_BLOCK = 1


class PagedKVCache(NamedTuple):
    """Every layer's block pool: k, v of shape
    ``(n_layers, n_blocks, block_size, n_kv, head_dim)``. Column ``c``,
    offset ``o`` of a row's table holds absolute position
    ``c * block_size + o``."""

    k: torch.Tensor
    v: torch.Tensor


class BlockAllocator:
    """Host-side free list + refcounts + prefix-share registry.

    The registry maps a hashable prefix key to a block id so cohorts with
    a common prompt head reuse blocks instead of recomputing/storing
    them; ``decref`` to zero returns the block to the free list and
    unpublishes it. Purely host-side bookkeeping — device pools are only
    ever *indexed* by the ids this hands out."""

    def __init__(self, n_blocks: int):
        if n_blocks <= RESERVED_BLOCKS:
            raise ValueError(f"need more than {RESERVED_BLOCKS} blocks "
                             f"(got {n_blocks}); ids 0/1 are reserved")
        self.n_blocks = n_blocks
        self._free: deque = deque(range(RESERVED_BLOCKS, n_blocks))
        self._ref = np.zeros(n_blocks, np.int64)
        self._registry: Dict[Hashable, int] = {}
        self._block_key: Dict[int, Hashable] = {}
        self.peak_blocks = 0
        self.shared_hits = 0

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - RESERVED_BLOCKS - len(self._free)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        """A fresh private block (refcount 1)."""
        if not self._free:
            raise RuntimeError(
                f"KV block pool exhausted ({self.n_blocks} blocks); size "
                f"the engine's pool for max_batch x ceil(max_seq/page_size)")
        bid = self._free.popleft()
        self._ref[bid] = 1
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use)
        return bid

    def incref(self, bid: int, *, shared: bool = False) -> None:
        """Add a reference. ``shared=True`` also counts a shared hit —
        intra-cohort dedup increfs directly (no registry round-trip) but
        is prefix sharing all the same."""
        self._ref[bid] += 1
        if shared:
            self.shared_hits += 1

    def decref(self, bid: int) -> None:
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            key = self._block_key.pop(bid, None)
            if key is not None:
                self._registry.pop(key, None)
            self._free.append(bid)
        elif self._ref[bid] < 0:
            raise RuntimeError(f"block {bid} decref'd below zero")

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def share(self, key: Hashable) -> Optional[int]:
        """Reuse the block published under ``key``: bumps its refcount
        and the shared-hit counter. None when nothing is published."""
        bid = self._registry.get(key)
        if bid is None:
            return None
        self._ref[bid] += 1
        self.shared_hits += 1
        return bid

    def publish(self, key: Hashable, bid: int) -> None:
        """Make ``bid`` reusable by later cohorts under ``key`` (the
        registry holds no refcount of its own — the entry dies with the
        block's last reference)."""
        self._registry[key] = bid
        self._block_key[bid] = key

    def reset_stats(self) -> None:
        """Restart peak/shared accounting from the current occupancy."""
        self.peak_blocks = self.blocks_in_use
        self.shared_hits = 0


def paged_compatible(cfg) -> bool:
    """Whether this model can serve from paged KV: every mixer is global
    causal attention."""
    return (all(k == ATTN for k in cfg.layer_kinds())
            and cfg.sliding_window == 0 and cfg.causal)


def init_paged_pools(model, n_blocks: int, block_size: int,
                     device) -> PagedKVCache:
    """Zeroed pools for every layer of ``model``, on ``device``."""
    cfg = model.cfg
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    dtype = getattr(torch, cfg.dtype)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def scatter_prefill_blocks(pools: PagedKVCache,
                           caches: Tuple[torch.Tensor, torch.Tensor],
                           rows: Sequence[int], cols: Sequence[int],
                           bids: Sequence[int], *, block_size: int) -> None:
    """Copy whole blocks out of a dense prefill cache into the pools, in
    place: entry ``m`` copies block ``cols[m]`` of prefill row
    ``rows[m]`` into pool block ``bids[m]``, in every layer at once.
    ``caches`` is ``Model.prefill``'s (k, v), each
    ``(n_layers, U, S, Hkv, D)`` with S a block multiple. Shared
    (registry-hit) blocks are not in the worklist."""
    if not len(bids):
        return
    dev = pools.k.device
    rows_t = to_device(rows, dev, np.int64)
    cols_t = to_device(cols, dev, np.int64)
    bids_t = to_device(bids, dev, np.int64)
    for pool, cache in zip(pools, caches):
        L, U, S, H, D = cache.shape
        blocks = cache.reshape(L, U, S // block_size, block_size, H, D)
        pool.index_copy_(1, bids_t, blocks[:, rows_t, cols_t].to(pool.dtype))

"""genesys.pagedkv — paged KV-cache pool over one preallocated arena.

The serving path allocates KV cache in fixed-size token blocks instead of
per-request contiguous buffers (vLLM's paged attention, reproduced over
the genesys memory stack):

  * one arena of ``n_blocks`` blocks of ``block_size`` token positions
    (the device side lives in ``models.transformer.init_paged_arena``
    arenas [L, NB, BS, KV, hd]; this class is the host-side allocator);
  * per-request **block tables** map a sequence's logical block index to
    an arena block id — the Pallas split-KV kernel and the XLA reference
    both read K/V through the table, so sequences are never copied or
    compacted;
  * a **free list** recycles blocks at request retirement;
  * **ref-counted blocks** let requests that share a prompt prefix share
    the prefix's full blocks (chained content hashes, one block table
    entry each, no copy): a sealed prefix block is retained at refcount
    0 in an LRU *cached* state and revived on the next hit.

Block id 0 is the **null block**: never allocated, the padding target for
short block tables and inactive batch slots (their masked writes land
there; nothing ever reads it back).

GENESYS binding (:meth:`bind_genesys`): each arena block is backed by an
``mmap`` region carved through the tenant ring against
:class:`~repro_torch.core.genesys.memory_pool.MemoryPool`, touched on
allocation and ``madvise(MADV_DONTNEED)``-ed on free — the pool's RSS
trace shows the paged cache's true working set (paper §7.2, the miniAMR
shrink pattern). Cold prefix blocks evicted from the arena can spill to
a file via ``PWRITE64`` and are fetched back with **PREAD64_FIXED** into
a staging buffer pinned via :meth:`Genesys.register_buffers` — the
registered-buffer read path skips the per-call heap resolve entirely
(io_uring READ_FIXED semantics), so a cold-page fill costs one ring
round-trip and one memcpy.

Single-owner discipline: the pool is mutated only from the engine's
scheduler loop thread; :class:`PagedKVStats` lives behind a
``trace.Counters`` record (the :attr:`PagedKVPool.counters` fold), so
``Genesys.telemetry()`` readers and metrics collectors on other threads
always see a consistent snapshot.
"""
from __future__ import annotations

import os
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.core.genesys import Sys
from repro_torch.core.genesys.memory_pool import MADV_DONTNEED
from repro_torch.core.genesys.trace import Counters

NULL_BLOCK = 0


class PoolExhausted(RuntimeError):
    """No free or evictable block is available for an allocation."""


@dataclass
class PagedKVStats:
    allocs: int = 0             # blocks handed out
    frees: int = 0              # blocks returned to the free list
    prefix_queries: int = 0     # prompt blocks looked up against the cache
    prefix_hits: int = 0        # lookups served from cache (arena or spill)
    spill_writes: int = 0       # evicted blocks written out via PWRITE64
    spill_bytes: int = 0        # bytes those spill writes moved
    spill_live_bytes: int = 0   # bytes of spill extents still revivable
    spill_compactions: int = 0  # spill-file compaction passes run
    fixed_reads: int = 0        # spilled blocks revived via PREAD64_FIXED
    revival_bytes: int = 0      # bytes those revivals read back
    evictions: int = 0          # cached blocks reclaimed for allocation
    sealed: int = 0             # blocks retained in the prefix cache
    blocks_in_use: int = 0      # currently referenced (refcount > 0)
    peak_blocks_in_use: int = 0

    def hit_rate(self) -> float:
        return self.prefix_hits / max(1, self.prefix_queries)


def chain_hashes(tokens, block_size: int) -> list[int]:
    """Chained content hashes of the full blocks covering ``tokens``:
    h_i = hash(h_{i-1}, tokens[i*BS:(i+1)*BS]). Chaining makes a block's
    identity depend on its whole prefix, so equal token windows at
    different depths never alias."""
    toks = [int(t) for t in tokens]
    out: list[int] = []
    h = 0x9E3779B9
    for i in range(len(toks) // block_size):
        h = hash((h, tuple(toks[i * block_size:(i + 1) * block_size])))
        out.append(h)
    return out


class PagedKVPool:
    """Host-side allocator for the paged KV arena (see module docstring)."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError("need at least the null block + one real block")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._free: deque[int] = deque(range(1, self.n_blocks))
        self._ref = [0] * self.n_blocks
        self._hash_of: list[int | None] = [None] * self.n_blocks
        # prefix hash -> ("arena", block_id) | ("spill", file_offset)
        self._by_hash: dict[int, tuple[str, int]] = {}
        # refcount-0 sealed blocks, LRU order (hash -> block_id)
        self._cached: OrderedDict[int, int] = OrderedDict()
        self.counters = Counters(PagedKVStats())
        # eviction spill hook: block_id -> serialized block bytes; wired
        # by the engine (only it can read the device arenas)
        self.extractor: Callable[[int], bytes] | None = None
        # genesys binding state (bind_genesys)
        self._gsys = None
        self._tenant = None
        self._addrs: list[int] = []
        self._block_bytes = 0
        self._spill_fd = -1
        self._spill_free: deque[int] = deque()
        self._spill_slots = 0
        self._spill_live = 0          # slots holding a revivable extent
        self._compact_ratio = 0.5
        self._stage = None
        self._stage_idx = -1
        self._stage_h = -1

    @property
    def stats(self) -> PagedKVStats:
        return self.counters.stats

    @stats.setter
    def stats(self, new) -> None:
        # benchmarks reset via ``pool.stats = PagedKVStats()``; swap under
        # the lock so attached telemetry references keep reading live data
        with self.counters.lock:
            self.counters.stats = new

    # ------------------------------------------------------------ genesys ----
    def bind_genesys(self, gsys, *, block_bytes: int,
                     spill_path: str | None = None,
                     spill_slots: int = 0,
                     spill_compact_ratio: float = 0.5) -> None:
        """Back the arena with genesys-managed memory and (optionally) a
        spill file for evicted prefix blocks.

        ``block_bytes`` is the serialized size of one block across all
        layers (k and v). Every block gets its own MemoryPool region,
        mmap'd through a dedicated ``pagedkv`` tenant ring; allocation
        touches the region resident, free MADV_DONTNEEDs it, so
        ``gsys.pool.rss_bytes`` tracks blocks actually holding KV.

        ``spill_compact_ratio`` triggers :meth:`compact_spill` from the
        spill path once live extents fall below that fraction of the
        slots in use (dead extents come from failed revivals and
        superseded hashes — the spill file never reuses a slot in place).
        """
        self._gsys = gsys
        self._block_bytes = int(block_bytes)
        gsys.attach_stats("pagedkv", self.counters)
        self._tenant = gsys.tenant("pagedkv", weight=2.0, fuse=True)
        # one region per block, carved as multi-entry ring submissions
        comps = self._tenant.submit(
            [(Sys.MMAP, 0, self._block_bytes)] * self.n_blocks)
        self._addrs = [c.result() for c in comps]
        if spill_path is not None:
            ph = gsys.heap.register_bytes(spill_path.encode())
            self._spill_fd = self._tenant.call(
                Sys.OPEN, ph, os.O_RDWR | os.O_CREAT, 0o644)
            gsys.heap.release(ph)
            self._spill_slots = int(spill_slots) or 4 * self.n_blocks
            self._spill_free = deque(range(self._spill_slots))
            self._compact_ratio = float(spill_compact_ratio)
            # PREAD64_FIXED staging buffer: registered once, resolved
            # never again — the zero-resolve decode-fill read path
            self._stage_h = gsys.heap.new_buffer(self._block_bytes)
            self._stage_idx = gsys.register_buffers([self._stage_h])[0]
            self._stage = gsys.heap.resolve(self._stage_h)

    def rss_bytes(self) -> int:
        return self._gsys.pool.rss_bytes if self._gsys is not None else 0

    def _touch(self, bid: int) -> None:
        if self._gsys is not None:
            self._gsys.pool.touch(self._addrs[bid])

    def _dontneed(self, bids) -> None:
        if self._tenant is None or not bids:
            return
        comps = self._tenant.submit(
            [(Sys.MADVISE, self._addrs[b], 0, MADV_DONTNEED) for b in bids])
        for c in comps:
            c.result()

    def _note_spill_live(self, delta: int) -> None:
        self._spill_live += delta
        live_bytes = self._spill_live * self._block_bytes
        self.counters.update(
            lambda s: setattr(s, "spill_live_bytes", live_bytes))

    def _spill_fragmented(self) -> bool:
        used = self._spill_slots - len(self._spill_free)
        return used > 0 and self._spill_live < used * self._compact_ratio

    def _spill(self, bid: int) -> None:
        """Write an evicted sealed block's contents to the spill file so a
        later prefix hit can revive it (PWRITE64 through the tenant ring)."""
        h = self._hash_of[bid]
        if h is None or self._spill_fd < 0 or self.extractor is None:
            if h is not None:
                self._by_hash.pop(h, None)
            return
        if not self._spill_free or self._spill_fragmented():
            self.compact_spill()
        if not self._spill_free:
            self._by_hash.pop(h, None)
            return
        payload = np.frombuffer(self.extractor(bid), dtype=np.uint8)
        if payload.nbytes != self._block_bytes:
            raise ValueError(
                f"extractor returned {payload.nbytes} bytes, expected "
                f"{self._block_bytes}")
        slot = self._spill_free.popleft()
        # one staging copy into an arena extent; the PWRITE64 itself goes
        # out zero-copy off the extent (in-place write handler)
        bh = self._gsys.heap.register_bytes(payload)
        try:
            n = self._tenant.call(Sys.PWRITE64, self._spill_fd, bh,
                                  self._block_bytes,
                                  slot * self._block_bytes)
        finally:
            self._gsys.heap.release(bh)
        if n != self._block_bytes:
            self._spill_free.append(slot)
            self._by_hash.pop(h, None)
            return
        self._by_hash[h] = ("spill", slot)
        self._note_spill_live(1)
        self.counters.add(spill_writes=1, spill_bytes=self._block_bytes)

    def _fetch_spill(self, slot: int) -> bytes:
        """Revive a spilled block: PREAD64_FIXED into the registered
        staging buffer — the fixed-buffer table is indexed directly by the
        handler, no HostHeap resolve on this hot path."""
        n = self._tenant.call(Sys.PREAD64_FIXED, self._spill_fd,
                              self._stage_idx, self._block_bytes,
                              slot * self._block_bytes)
        if n != self._block_bytes:
            raise OSError(f"short spill read: {n} != {self._block_bytes}")
        self.counters.add(fixed_reads=1, revival_bytes=self._block_bytes)
        self._spill_free.append(slot)
        return bytes(np.asarray(self._stage)[:self._block_bytes].tobytes())

    def compact_spill(self) -> int:
        """Reclaim dead spill-file extents. Slots whose entry was dropped
        — a revival's PREAD failed mid-flight, or its hash was superseded
        — are never reused in place; they accumulate until this pass
        relocates every live extent down to the lowest slot indices and
        rebuilds the free list from everything above the live watermark.
        Returns the number of slots reclaimed."""
        if self._spill_fd < 0 or not self._spill_slots:
            return 0
        live = sorted((slot, h) for h, (kind, slot) in self._by_hash.items()
                      if kind == "spill")
        before = len(self._spill_free)
        dst = 0
        for src, h in live:
            if src != dst:
                # relocate through the registered staging buffer: one
                # PREAD64_FIXED + one PWRITE64_FIXED per surviving extent
                # — both directions index the pinned stage directly, no
                # copy-out/register/release round trip per block; live
                # slots are sorted ascending so dst never passes src and
                # no unmoved extent can be overwritten
                n = self._tenant.call(Sys.PREAD64_FIXED, self._spill_fd,
                                      self._stage_idx, self._block_bytes,
                                      src * self._block_bytes)
                if n != self._block_bytes:
                    self._by_hash.pop(h, None)
                    self._note_spill_live(-1)
                    continue
                w = self._tenant.call(Sys.PWRITE64_FIXED, self._spill_fd,
                                      self._stage_idx, self._block_bytes,
                                      dst * self._block_bytes)
                if w != self._block_bytes:
                    self._by_hash.pop(h, None)
                    self._note_spill_live(-1)
                    continue
                self._by_hash[h] = ("spill", dst)
            dst += 1
        self._spill_free = deque(range(dst, self._spill_slots))
        self.counters.add(spill_compactions=1)
        return len(self._spill_free) - before

    # --------------------------------------------------------- allocation ----
    def free_blocks(self) -> int:
        return len(self._free) + len(self._cached)

    def _use(self, n: int) -> None:
        def bump(s: PagedKVStats) -> None:
            s.blocks_in_use += n
            if s.blocks_in_use > s.peak_blocks_in_use:
                s.peak_blocks_in_use = s.blocks_in_use
        self.counters.update(bump)

    def _evict_one(self) -> int:
        """Reclaim the least-recently-used cached prefix block (spilling
        its contents if a spill file is bound)."""
        h, bid = self._cached.popitem(last=False)
        self._spill(bid)
        if self._by_hash.get(h, (None, None))[0] == "arena":
            self._by_hash.pop(h, None)
        self._hash_of[bid] = None
        self.counters.add(evictions=1)
        return bid

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` blocks off the free list (evicting LRU cached prefix
        blocks as needed). Raises :class:`PoolExhausted` — and allocates
        nothing — if fewer than ``n`` are reclaimable."""
        if n <= 0:
            return []
        if len(self._free) + len(self._cached) < n:
            raise PoolExhausted(
                f"need {n} blocks, have {len(self._free)} free + "
                f"{len(self._cached)} cached")
        out: list[int] = []
        for _ in range(n):
            bid = self._free.popleft() if self._free else self._evict_one()
            self._ref[bid] = 1
            self._hash_of[bid] = None
            self._touch(bid)
            out.append(bid)
        self.counters.add(allocs=n)
        self._use(n)
        return out

    # ------------------------------------------------------- prefix reuse ----
    def acquire_prefix(self, tokens) -> tuple[list[int], list[tuple[int, bytes]]]:
        """Reuse the longest cached chain of full blocks covering
        ``tokens`` (the caller passes only the prompt span it is willing
        to skip — see engine.admit). Returns ``(block_ids, fetches)``:
        ``block_ids`` to place at the head of the request's block table
        (ref-counted up), and ``fetches`` — ``(block_id, payload)`` pairs
        for blocks revived from spill whose contents the caller must
        install into the device arenas before decoding.
        """
        ids: list[int] = []
        fetches: list[tuple[int, bytes]] = []
        for h in chain_hashes(tokens, self.block_size):
            self.counters.add(prefix_queries=1)
            loc = self._by_hash.get(h)
            if loc is None:
                break
            kind, where = loc
            if kind == "arena":
                bid = where
                if self._ref[bid] == 0:
                    self._cached.pop(h, None)
                    self._use(1)
                self._ref[bid] += 1
                ids.append(bid)
            else:
                # spill hit: revive into a fresh arena block
                try:
                    payload = self._fetch_spill(where)
                    bid = self.alloc(1)[0]
                except (PoolExhausted, OSError):
                    # the extent is dead either way; a failed PREAD also
                    # leaks its slot until compact_spill reclaims it
                    self._by_hash.pop(h, None)
                    self._note_spill_live(-1)
                    break
                self._hash_of[bid] = h
                self._by_hash[h] = ("arena", bid)
                self._note_spill_live(-1)
                fetches.append((bid, payload))
                ids.append(bid)
            self.counters.add(prefix_hits=1)
        return ids, fetches

    def retire(self, block_ids, prompt_tokens=None) -> None:
        """Return a finished request's blocks. Blocks fully covered by
        ``prompt_tokens`` are sealed into the prefix cache first (so the
        next request sharing the prompt reuses them); every block's
        refcount drops, and blocks reaching 0 either park in the LRU
        cache (sealed) or rejoin the free list."""
        block_ids = list(block_ids)
        n_seal = 0
        if prompt_tokens is not None:
            hashes = chain_hashes(prompt_tokens, self.block_size)
            n_seal = min(len(hashes), len(block_ids))
            for h, bid in zip(hashes[:n_seal], block_ids[:n_seal]):
                cur = self._by_hash.get(h)
                if cur is not None and cur != ("arena", bid):
                    continue    # another copy already owns this hash
                if self._hash_of[bid] is None:
                    self._by_hash[h] = ("arena", bid)
                    self._hash_of[bid] = h
                    self.counters.add(sealed=1)
        drop: list[int] = []
        for bid in block_ids:
            if bid == NULL_BLOCK:
                continue
            self._ref[bid] -= 1
            if self._ref[bid] > 0:
                continue
            self.counters.add(blocks_in_use=-1)
            h = self._hash_of[bid]
            if h is not None and self._by_hash.get(h) == ("arena", bid):
                self._cached[h] = bid       # park, LRU-evictable
                self._cached.move_to_end(h)
            else:
                self._hash_of[bid] = None
                self._free.append(bid)
                self.counters.add(frees=1)
                drop.append(bid)
        self._dontneed(drop)

"""genesys.arena: the unified registered-buffer arena — the zero-copy
data plane.

The paper's calling convention rests on shared virtual memory: syscall
arguments are raw pointers and the OS moves bytes directly to/from the
GPU program's buffers, with no marshalling copy on either side.
:class:`~repro_torch.core.genesys.heap.HostHeap` stood in for that with a
dict-of-objects handle registry — correct, but every hot call paid a
lock + dict resolve, and every completion paid one or more numpy copies
(``os.pread`` -> bytes -> ``frombuffer`` -> slice store).

:class:`HostArena` replaces it as the default data plane (GPUstore's
argument: pre-register buffers once, then move bytes exactly once):

  * every buffer from :meth:`new_buffer` / :meth:`register_bytes` /
    :meth:`carve` is an *extent* of one backing ``np.uint8`` segment,
    registered at carve time — FIXED-style index addressing is the
    default calling convention, not the ``register_buffers()`` opt-in;
  * a handle encodes ``(arena tag | generation | extent index)`` in one
    u64 that still fits a syscall arg slot, so :meth:`resolve` on the
    hot path is a lock-free list index + generation check returning a
    pre-built bounds-exact view — no dict, no lock, no copy;
  * handlers with an arena destination land bytes **in place**
    (``os.preadv`` / ``socket.recvfrom_into`` into the extent) and
    gather-side handlers send **from place** (``os.pwrite`` /
    ``sendto`` straight off the extent's buffer protocol) — see
    ``syscalls.py``;
  * released extents return to per-size-class free lists and are reused
    by later carves. Reuse is safe against stragglers because release
    bumps the extent's *generation*: a stale handle (the dict registry's
    "handles are never reused" property, preserved here) resolves to
    ``KeyError`` -> ``-EIO``, never to somebody else's bytes. Fresh
    carves from :meth:`new_buffer` are zero-filled, so reuse can never
    leak a previous tenant's bytes;
  * foreign objects (``register()``) keep the inherited dict-of-objects
    semantics — existing callers that register their own numpy arrays /
    bytes still work, they just stay on the (copying) legacy path.

Vectorized scatter/gather: :meth:`locate` exposes ``(segment, offset,
length)`` descriptors so genesys.fuse can scatter a merged read's
scratch into N member extents as ONE fancy-index store per backing
segment instead of N python-loop slice copies (``fuse.py``).

Thread-safety: carve/release mutate the free lists under the heap lock;
``resolve``/``view``/``locate`` are lock-free (CPython list indexing is
atomic under the GIL; ``release`` publishes the generation bump before
dropping the view, so a racing reader sees either the live view or a
stale-generation miss — the same use-after-release contract the dict
registry had).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.genesys.heap import HostHeap

# handle layout: | arena tag (bit 60) | generation (32b) | extent idx (24b) |
# bit 60 keeps handles positive in int64 AND disjoint from dict handles
# (small ints), so one u64 arg slot carries either kind.
ARENA_BIT = 1 << 60
_IDX_BITS = 24
_IDX_MASK = (1 << _IDX_BITS) - 1
_GEN_MASK = (1 << 32) - 1

_ALIGN = 64                 # smallest size class; keeps every offset 64B-aligned
_LARGE = 1 << 20            # carves >= this get a dedicated segment
_SEG_CAP = 16 << 20         # geometric segment growth stops doubling here


def _size_class(nbytes: int) -> int:
    """Capacity bucket for an extent: pow2 (>= 64B) below the large
    threshold, 4 KiB-rounded exact size above it. Pow2 classes make free
    list reuse O(1); large extents round to pages so repeated same-shape
    carves (checkpoint leaves, spill blocks) reuse each other's
    segments."""
    n = max(int(nbytes), 1)
    if n >= _LARGE:
        return (n + 4095) & ~4095
    c = _ALIGN
    while c < n:
        c <<= 1
    return c


class HostArena(HostHeap):
    """Registered-buffer arena (see module docstring). Drop-in for
    :class:`HostHeap`: the inherited dict registry still backs
    ``register()`` (foreign objects), while ``new_buffer`` /
    ``register_bytes`` / ``carve`` hand out arena extents."""

    def __init__(self, *, segment_bytes: int = 1 << 20):
        super().__init__()
        self._seg0 = max(int(segment_bytes), _ALIGN)
        self._next_seg = self._seg0
        self._segments: list[np.ndarray] = []
        self._cur = -1              # bump-allocating segment index
        self._cur_off = 0
        # extent descriptor columns, indexed by extent idx (append-only;
        # entries are recycled via the free lists, never removed)
        self._views: list[np.ndarray | None] = []
        self._gens: list[int] = []
        self._seg_of: list[int] = []
        self._off: list[int] = []
        self._cap: list[int] = []
        self._nbytes: list[int] = []
        # numpy mirrors of the columns above (grown geometrically), so
        # :meth:`locate_batch` can qualify a whole fused group with array
        # ops instead of a per-member python loop — the difference between
        # the vectorized scatter winning and losing to the serial loop.
        # Row 0 is a TAG (gen << 1 | live): one fancy-index compare checks
        # generation AND liveness together.
        self._ncols = np.zeros((4, 64), dtype=np.int64)  # tag/seg/off/nbytes
        self._free: dict[int, list[int]] = {}   # size class -> extent idxs
        self._live = 0
        self._reused = 0
        # optional copy-accounting hook: fn(path, nbytes) — Genesys wires
        # it to SyscallTable.note_copy so register_bytes copy-ins are a
        # measured, per-path number (genesys_bytes_copied_total)
        self.on_copy = None

    # -- allocation -----------------------------------------------------------
    def _alloc_locked(self, cap: int) -> tuple[int, int]:
        """Reserve ``cap`` fresh bytes; returns (segment idx, offset)."""
        if cap >= _LARGE:
            self._segments.append(np.zeros(cap, dtype=np.uint8))
            return len(self._segments) - 1, 0
        if self._cur < 0 or self._cur_off + cap > self._segments[self._cur].size:
            size = max(self._next_seg, cap)
            self._next_seg = min(self._next_seg * 2, _SEG_CAP)
            self._segments.append(np.zeros(size, dtype=np.uint8))
            self._cur = len(self._segments) - 1
            self._cur_off = 0
        off = self._cur_off
        self._cur_off += cap
        return self._cur, off

    def carve(self, nbytes: int, *, zero: bool = False) -> int:
        """Allocate (or reuse) an extent of exactly ``nbytes`` and return
        its registered handle. ``zero=True`` clears it (the no-stale-bytes
        guarantee ``new_buffer`` gives across carve/release reuse)."""
        n = int(nbytes)
        if n < 0:
            raise ValueError(f"carve({nbytes})")
        cap = _size_class(n)
        with self._lock:
            free = self._free.get(cap)
            if free:
                idx = free.pop()
                seg_i, off = self._seg_of[idx], self._off[idx]
                self._reused += 1
            else:
                seg_i, off = self._alloc_locked(cap)
                idx = len(self._gens)
                if idx > _IDX_MASK:
                    raise MemoryError("arena extent index space exhausted")
                self._gens.append(0)
                self._seg_of.append(seg_i)
                self._off.append(off)
                self._cap.append(cap)
                self._views.append(None)
                self._nbytes.append(0)
                if idx >= self._ncols.shape[1]:
                    grown = np.zeros((4, 2 * self._ncols.shape[1]),
                                     dtype=np.int64)
                    grown[:, :self._ncols.shape[1]] = self._ncols
                    self._ncols = grown
                self._ncols[1, idx] = seg_i
                self._ncols[2, idx] = off
            view = self._segments[seg_i][off:off + n]
            self._nbytes[idx] = n
            self._views[idx] = view
            gen = self._gens[idx]
            self._ncols[3, idx] = n
            self._ncols[0, idx] = (gen << 1) | 1
            self._live += 1
        if zero and n:
            view[:] = 0
        return ARENA_BIT | ((gen & _GEN_MASK) << _IDX_BITS) | idx

    # -- the HostHeap surface -------------------------------------------------
    def new_buffer(self, nbytes: int) -> int:
        return self.carve(nbytes, zero=True)

    def register_bytes(self, data, path: str = "register") -> int:
        """Copy ``data`` (bytes-like or a 1-D uint8 array) into a fresh
        extent — the ONE gather-side marshalling copy the data plane still
        pays, counted under ``path`` via the :attr:`on_copy` hook."""
        if isinstance(data, np.ndarray):
            src = data.reshape(-1).view(np.uint8)
        else:
            src = np.frombuffer(data, dtype=np.uint8)
        h = self.carve(src.size)
        if src.size:
            self.view(h)[:] = src
        if self.on_copy is not None:
            self.on_copy(path, src.size)
        return h

    def resolve(self, handle):
        h = int(handle)
        if not (h & ARENA_BIT):
            return super().resolve(h)
        idx = h & _IDX_MASK
        try:
            if ((h >> _IDX_BITS) & _GEN_MASK) == self._gens[idx]:
                v = self._views[idx]
                if v is not None:
                    return v
        except IndexError:
            pass
        raise KeyError(handle)      # stale generation: released extent

    def resolve_many(self, handles) -> dict:
        out = {}
        foreign = []
        for x in handles:
            h = int(x)
            if h & ARENA_BIT:
                v = self.view(h)
                if v is not None:
                    out[h] = v
            else:
                foreign.append(h)
        if foreign:
            out.update(super().resolve_many(foreign))
        return out

    def release(self, handle) -> None:
        """Return an extent to its size-class free list (idempotent, like
        the dict registry: a stale or repeated handle is a no-op). The
        generation bump makes every outstanding copy of the handle dead
        *before* the extent can be re-carved."""
        h = int(handle)
        if not (h & ARENA_BIT):
            return super().release(h)
        idx = h & _IDX_MASK
        with self._lock:
            if idx >= len(self._gens) \
                    or ((h >> _IDX_BITS) & _GEN_MASK) != self._gens[idx] \
                    or self._views[idx] is None:
                return
            self._gens[idx] += 1
            self._views[idx] = None
            self._ncols[0, idx] = self._gens[idx] << 1  # live bit cleared
            self._free.setdefault(self._cap[idx], []).append(idx)
            self._live -= 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._objs) + self._live

    # -- zero-copy fast-path surface (syscalls.py / fuse.py) ------------------
    @staticmethod
    def is_arena_handle(handle) -> bool:
        return bool(int(handle) & ARENA_BIT)

    def view(self, handle):
        """The extent's backing view, or ``None`` when ``handle`` is not a
        *live* arena extent (foreign, stale, or garbage) — the one check
        the in-place syscall fast paths make before touching memory."""
        h = int(handle)
        if not (h & ARENA_BIT):
            return None
        idx = h & _IDX_MASK
        try:
            if ((h >> _IDX_BITS) & _GEN_MASK) != self._gens[idx]:
                return None
            return self._views[idx]
        except IndexError:
            return None

    def locate(self, handle):
        """``(segment idx, offset, nbytes)`` for a live arena extent, else
        ``None`` — the descriptor genesys.fuse groups by segment to turn
        per-member scatter copies into one fancy-index store."""
        h = int(handle)
        if not (h & ARENA_BIT):
            return None
        idx = h & _IDX_MASK
        try:
            if ((h >> _IDX_BITS) & _GEN_MASK) != self._gens[idx] \
                    or self._views[idx] is None:
                return None
            return self._seg_of[idx], self._off[idx], self._nbytes[idx]
        except IndexError:
            return None

    def locate_batch(self, handles: np.ndarray):
        """Vectorized :meth:`locate` over an int64 handle array: returns
        ``(seg, off, nbytes)`` int64 column arrays, or ``None`` if ANY
        handle is foreign, stale, or dead — all-or-nothing, because the
        caller (the fused scatter) needs the serial loop to own per-member
        error semantics the moment one member is unhealthy."""
        h = np.asarray(handles, dtype=np.int64)
        if h.size == 0 or int(h.min()) < ARENA_BIT:
            return None     # a foreign (dict-heap) handle is a small int
        idx = h & _IDX_MASK
        cols = self._ncols                          # one snapshot of the ref
        if int(idx.max()) >= cols.shape[1]:
            return None
        want = (((h >> _IDX_BITS) & _GEN_MASK) << 1) | 1
        if (cols[0, idx] != want).any():            # stale gen OR dead
            return None
        return cols[1, idx], cols[2, idx], cols[3, idx]

    def segment(self, seg_idx: int) -> np.ndarray:
        return self._segments[seg_idx]

    # -- introspection --------------------------------------------------------
    def arena_stats(self) -> dict:
        with self._lock:
            return {
                "segments": len(self._segments),
                "bytes_reserved": int(sum(s.size for s in self._segments)),
                "extents_live": self._live,
                "extents_total": len(self._gens),
                "reused": self._reused,
                "foreign": len(self._objs),
            }

"""Host memory pool backing mmap/munmap/madvise syscalls (paper §7.2).

The miniAMR case study shows a device program shrinking its resident set by
madvise(MADV_DONTNEED)-ing regions it no longer needs. We model an OS memory
manager: mmap reserves a region (not resident until touched), touching makes
pages resident, madvise(DONTNEED) drops residency without unmapping. The RSS
trace (paper Fig 9's step curve) is recorded for the benchmark.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

PAGE = 4096

MADV_NORMAL = 0
MADV_WILLNEED = 3
MADV_DONTNEED = 4


@dataclass
class Region:
    addr: int
    length: int
    resident_pages: set = field(default_factory=set)


class MemoryPool:
    def __init__(self):
        self._lock = threading.Lock()
        self._next_addr = 0x10000
        self._regions: dict[int, Region] = {}
        self._rss_pages = 0
        self._trace: list[tuple[float, int]] = []
        self._t0 = time.monotonic()

    def _record(self):
        self._trace.append((time.monotonic() - self._t0, self.rss_bytes_unlocked()))

    def rss_bytes_unlocked(self) -> int:
        return self._rss_pages * PAGE

    # -- syscall handlers -----------------------------------------------------
    def mmap(self, length: int) -> int:
        return self.mmap_many(length, 1)[0]

    def mmap_many(self, length: int, n: int) -> list[int]:
        """Batched mmap (genesys.fuse size-class batching): carve ``n``
        regions of ``length`` bytes under ONE lock round and one RSS-trace
        record — per-region cost collapses to a dict insert."""
        length = ((int(length) + PAGE - 1) // PAGE) * PAGE
        addrs: list[int] = []
        with self._lock:
            for _ in range(int(n)):
                addr = self._next_addr
                self._next_addr += length + PAGE  # guard page gap
                self._regions[addr] = Region(addr=addr, length=length)
                addrs.append(addr)
            self._record()
        return addrs

    def munmap(self, addr: int, length: int = 0) -> int:
        with self._lock:
            r = self._regions.pop(int(addr), None)
            if r is None:
                return -22  # -EINVAL
            self._rss_pages -= len(r.resident_pages)
            self._record()
            return 0

    def madvise(self, addr: int, length: int, advice: int) -> int:
        with self._lock:
            r = self._regions.get(int(addr))
            if r is None:
                return -22
            length = int(length) or r.length
            pages = range(0, min(length, r.length) // PAGE)
            if advice == MADV_DONTNEED:
                drop = [p for p in pages if p in r.resident_pages]
                for p in drop:
                    r.resident_pages.discard(p)
                self._rss_pages -= len(drop)
            elif advice == MADV_WILLNEED:
                self._touch_unlocked(r, pages)
            self._record()
            return 0

    # -- residency (touching = first write, as the OS would fault pages in) ---
    def _touch_unlocked(self, r: Region, pages) -> None:
        new = [p for p in pages if p not in r.resident_pages]
        r.resident_pages.update(new)
        self._rss_pages += len(new)

    def touch(self, addr: int, length: int = 0) -> int:
        with self._lock:
            r = self._regions.get(int(addr))
            if r is None:
                return -22
            length = int(length) or r.length
            self._touch_unlocked(r, range(0, min(length, r.length) // PAGE))
            self._record()
            return 0

    # -- introspection ---------------------------------------------------------
    @property
    def rss_bytes(self) -> int:
        with self._lock:
            return self.rss_bytes_unlocked()

    @property
    def mapped_bytes(self) -> int:
        with self._lock:
            return sum(r.length for r in self._regions.values())

    def trace(self) -> list[tuple[float, int]]:
        with self._lock:
            return list(self._trace)

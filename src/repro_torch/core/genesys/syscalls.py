"""Syscall numbers and host-side handlers.

GENESYS implements 11 Linux syscalls spanning filesystem, network, and
memory (paper §5): read, write, pread, pwrite, open, close, sendto,
recvfrom, mmap, munmap, madvise. We implement the same set (real files and
real UDP sockets; memory against :class:`MemoryPool`), plus getrusage-style
introspection (paper §1: 'getrusage can be adapted to return information
about GPU resource usage').

Buffer/string arguments are heap handles (see heap.py / arena.py). Numbers
follow x86_64 where one exists.

Zero-copy completions: when the buffer argument is a live arena extent
(``heap.view(h)`` is not ``None``), read-side handlers land bytes in place
(``os.preadv`` / ``socket.recvfrom_into`` into the extent) and write-side
handlers send from place (``os.pwrite`` / ``sendto`` straight off the
extent's buffer protocol) — the completion IS the data delivery, with no
intermediate bytes object. Foreign handles keep the seed copy path, and
every marshalling copy that path still pays is metered through
:meth:`SyscallTable.note_copy` into :attr:`SyscallTable.copies`
(``genesys_bytes_copied_total``).
"""
from __future__ import annotations

import dataclasses
import os
import socket
import threading
from enum import IntEnum
from typing import Callable

import numpy as np

from repro_torch.core.genesys.heap import HostHeap
from repro_torch.core.genesys.memory_pool import MemoryPool
from repro_torch.core.genesys.trace import Counters

# os.preadv/readv exist on every Linux we target; guard anyway so the
# legacy copy path keeps the table importable elsewhere
_HAS_PREADV = hasattr(os, "preadv")


class Sys(IntEnum):
    READ = 0
    WRITE = 1
    OPEN = 2
    CLOSE = 3
    MMAP = 9
    MUNMAP = 11
    MADVISE = 28
    PREAD64 = 17
    PWRITE64 = 18
    SENDTO = 44
    RECVFROM = 45
    SOCKET = 41
    BIND = 49
    GETRUSAGE = 98
    # GENESYS extensions (paper §8.1 class-2: adapted semantics)
    CLOCK_GETTIME = 228
    # pure-overhead call (returns arg0): the echo microbenchmark floor for
    # the doorbell-vs-ring studies (benchmarks/fig8_uring.py)
    ECHO = 1000
    # registered-buffer variants (io_uring *_FIXED analogue): the buffer
    # argument is an index into the table pinned by Genesys.register_buffers,
    # skipping the per-call HostHeap lock/dict resolve on the hot path
    PREAD64_FIXED = 1001
    RECVFROM_FIXED = 1002
    # gather-side fixed variants (the fuse.py open item): write/send
    # straight out of a pinned buffer, fusable by the Coalescer
    PWRITE64_FIXED = 1003
    SENDTO_FIXED = 1004


# dispatch() is on every worker's hot path: resolve names without a per-call
# enum construction (and never rebuild the membership set per call)
_SYS_NAMES = {int(s): s.name for s in Sys}

Handler = Callable[..., int]


@dataclasses.dataclass
class CopyStats:
    """Marshalling bytes the data plane still copies, by path. The
    zero-copy refactor's success metric is these trending to ~0 on arena
    workloads (ROADMAP: "bytes-copied-per-call counter trending to ~0").

    Paths: ``resolve`` = per-call copy through a resolved heap object
    (legacy pread/recvfrom/pwrite/sendto marshalling), ``scatter`` =
    fused-read scratch -> member buffers, ``gather`` = member buffers ->
    fused-write scratch, ``reply`` = serving reply payload staging,
    ``register`` = generic register_bytes copy-ins."""
    resolve: int = 0
    scatter: int = 0
    gather: int = 0
    reply: int = 0
    register: int = 0
    events: int = 0
    per_tenant: dict = dataclasses.field(default_factory=dict)


class SyscallTable:
    """number -> handler registry; the dispatch side of the paper's Fig 2."""

    def __init__(self, heap: HostHeap, pool: MemoryPool):
        self.heap = heap
        self.pool = pool
        self._handlers: dict[int, Handler] = {}
        self._fd_lock = threading.Lock()
        self._sockets: dict[int, socket.socket] = {}
        # dispatch runs on all workers; Counters is the shared genesys
        # stats discipline (one lock for mutation AND snapshot)
        self.counters = Counters({})
        self.stats: dict[str, int] = self.counters.stats
        # bytes-copied accounting (genesys_bytes_copied_total); the owner
        # for per-tenant attribution rides worker-thread TLS, set once per
        # Executor.dispatch_call rather than threaded through every handler
        self.copies = Counters(CopyStats())
        self._copy_tls = threading.local()
        # registered buffers: append-only index table; reads are lock-free
        # (list indexing is atomic under the GIL), which is the whole point
        self._fixed: list = []
        self._fixed_lock = threading.Lock()

    def note_copy(self, path: str, nbytes: int, owner=None) -> None:
        """Count ``nbytes`` of marshalling copy under ``path`` (a
        :class:`CopyStats` field), attributed to ``owner`` (defaults to
        the dispatching tenant via TLS)."""
        n = int(nbytes)
        if n <= 0:
            return
        if owner is None:
            owner = getattr(self._copy_tls, "owner", None)
        with self.copies.lock:
            s = self.copies.stats
            setattr(s, path, getattr(s, path) + n)
            s.events += 1
            if owner is not None:
                s.per_tenant[owner] = s.per_tenant.get(owner, 0) + n

    def register_fixed(self, buf) -> int:
        """Pin a buffer into the fixed-buffer table; returns its index
        (the *_FIXED syscalls' buffer argument)."""
        with self._fixed_lock:
            self._fixed.append(buf)
            return len(self._fixed) - 1

    def register(self, no: int, fn: Handler) -> None:
        self._handlers[int(no)] = fn

    def dispatch(self, sysno: int, args) -> int:
        sysno = int(sysno)
        fn = self._handlers.get(sysno)
        if fn is None:
            return -38  # -ENOSYS
        name = _SYS_NAMES.get(sysno) or str(sysno)
        self.counters.bump(name)
        if isinstance(args, np.ndarray):
            args = args.tolist()        # one C-level conversion, not 6 int()s
        else:
            args = [int(a) for a in args]
        try:
            return int(fn(*args))
        except OSError as e:
            return -int(e.errno or 5)

    # ---- filesystem ----------------------------------------------------------
    def _sys_open(self, path_h, flags, mode, *_):
        path = bytes(self.heap.resolve(path_h)).decode()
        return os.open(path, flags, mode or 0o644)

    def _sys_close(self, fd, *_):
        sock = self._sockets.pop(fd, None)
        if sock is not None:
            sock.close()
            return 0
        os.close(fd)
        return 0

    def _sys_read(self, fd, buf_h, count, *_):
        dst = self.heap.view(buf_h)
        if _HAS_PREADV and dst is not None and 0 < count <= dst.size:
            return os.readv(fd, [dst[:count]])      # in place, zero-copy
        buf = self.heap.resolve(buf_h)
        data = os.read(fd, count)
        n = len(data)
        np.asarray(buf)[:n] = np.frombuffer(data, dtype=np.uint8)
        self.note_copy("resolve", n)
        return n

    def _sys_write(self, fd, buf_h, count, *_):
        src = self.heap.view(buf_h)
        if src is not None and 0 <= count <= src.size:
            return os.write(fd, src[:count])        # from place, zero-copy
        buf = self.heap.resolve(buf_h)
        data = np.asarray(buf)[:count].tobytes()
        self.note_copy("resolve", len(data))
        return os.write(fd, data)

    def _sys_pread(self, fd, buf_h, count, offset, dst_off=0, *_):
        dst = self.heap.view(buf_h)
        if _HAS_PREADV and dst is not None and 0 <= dst_off \
                and 0 < count and dst_off + count <= dst.size:
            return os.preadv(fd, [dst[dst_off:dst_off + count]], offset)
        buf = self.heap.resolve(buf_h)
        data = os.pread(fd, count, offset)
        n = len(data)
        np.asarray(buf)[dst_off:dst_off + n] = np.frombuffer(data, dtype=np.uint8)
        self.note_copy("resolve", n)
        return n

    def _sys_pread_fixed(self, fd, buf_idx, count, offset, dst_off=0, *_):
        buf = self._fixed[buf_idx]     # registered buffer: no heap resolve
        arr = np.asarray(buf)
        if _HAS_PREADV and arr.dtype == np.uint8 and arr.ndim == 1 \
                and arr.flags.c_contiguous and 0 <= dst_off \
                and 0 < count and dst_off + count <= arr.size:
            return os.preadv(fd, [arr[dst_off:dst_off + count]], offset)
        data = os.pread(fd, count, offset)
        n = len(data)
        arr[dst_off:dst_off + n] = np.frombuffer(data, dtype=np.uint8)
        self.note_copy("resolve", n)
        return n

    def _sys_pwrite(self, fd, buf_h, count, offset, src_off=0, *_):
        src = self.heap.view(buf_h)
        if src is not None and 0 <= src_off \
                and src_off + count <= src.size:
            return os.pwrite(fd, src[src_off:src_off + count], offset)
        buf = self.heap.resolve(buf_h)
        data = np.asarray(buf)[src_off:src_off + count].tobytes()
        self.note_copy("resolve", len(data))
        return os.pwrite(fd, data, offset)

    def _sys_pwrite_fixed(self, fd, buf_idx, count, offset, src_off=0, *_):
        buf = self._fixed[buf_idx]     # registered buffer: no heap resolve
        arr = np.asarray(buf)
        if arr.dtype == np.uint8 and arr.ndim == 1 and arr.flags.c_contiguous \
                and 0 <= src_off and src_off + count <= arr.size:
            return os.pwrite(fd, arr[src_off:src_off + count], offset)
        data = arr[src_off:src_off + count].tobytes()
        self.note_copy("resolve", len(data))
        return os.pwrite(fd, data, offset)

    # ---- network (UDP, as in the paper's echo server §7.3) -------------------
    def _sys_socket(self, family, type_, proto, *_):
        s = socket.socket(family or socket.AF_INET, type_ or socket.SOCK_DGRAM,
                          proto)
        fd = s.fileno()
        with self._fd_lock:
            self._sockets[fd] = s
        return fd

    def _sys_bind(self, fd, port, *_):
        s = self._sockets[fd]
        s.bind(("127.0.0.1", port))
        return 0

    def _sys_sendto(self, fd, buf_h, count, port, src_off=0, *_):
        s = self._sockets[fd]
        src = self.heap.view(buf_h)
        if src is not None and 0 <= src_off \
                and src_off + count <= src.size:
            return s.sendto(src[src_off:src_off + count], ("127.0.0.1", port))
        buf = self.heap.resolve(buf_h)
        data = np.asarray(buf)[src_off:src_off + count].tobytes()
        self.note_copy("resolve", len(data))
        return s.sendto(data, ("127.0.0.1", port))

    def _sys_sendto_fixed(self, fd, buf_idx, count, port, src_off=0, *_):
        s = self._sockets[fd]
        buf = self._fixed[buf_idx]     # registered buffer: no heap resolve
        arr = np.asarray(buf)
        if arr.dtype == np.uint8 and arr.ndim == 1 and arr.flags.c_contiguous \
                and 0 <= src_off and src_off + count <= arr.size:
            return s.sendto(arr[src_off:src_off + count], ("127.0.0.1", port))
        data = arr[src_off:src_off + count].tobytes()
        self.note_copy("resolve", len(data))
        return s.sendto(data, ("127.0.0.1", port))

    def _sys_recvfrom(self, fd, buf_h, count, *_):
        s = self._sockets[fd]
        dst = self.heap.view(buf_h)
        # recvfrom_into(buf, 0) means "fill the whole buffer" — only take
        # the in-place path for a positive count that fits the extent
        if dst is not None and 0 < count <= dst.size:
            n, _addr = s.recvfrom_into(dst[:count], count)
            return n
        data, _addr = s.recvfrom(count)
        buf = self.heap.resolve(buf_h)
        n = len(data)
        np.asarray(buf)[:n] = np.frombuffer(data, dtype=np.uint8)
        self.note_copy("resolve", n)
        return n

    def _sys_recvfrom_fixed(self, fd, buf_idx, count, *_):
        s = self._sockets[fd]
        buf = self._fixed[buf_idx]     # registered buffer: no heap resolve
        arr = np.asarray(buf)
        if arr.dtype == np.uint8 and arr.ndim == 1 and arr.flags.c_contiguous \
                and 0 < count <= arr.size:
            n, _addr = s.recvfrom_into(arr[:count], count)
            return n
        data, _addr = s.recvfrom(count)
        n = len(data)
        arr[:n] = np.frombuffer(data, dtype=np.uint8)
        self.note_copy("resolve", n)
        return n

    # ---- memory ----------------------------------------------------------------
    def _sys_mmap(self, addr, length, *_):
        return self.pool.mmap(length)

    def _sys_munmap(self, addr, length, *_):
        return self.pool.munmap(addr, length)

    def _sys_madvise(self, addr, length, advice, *_):
        return self.pool.madvise(addr, length, advice)

    # ---- introspection ----------------------------------------------------------
    def _sys_getrusage(self, who, out_h, *_):
        # Adapted semantics: report GENESYS resource usage (paper §1).
        total = sum(self.stats.values())
        if out_h:
            buf = np.asarray(self.heap.resolve(out_h))
            buf[: 8] = np.frombuffer(np.int64(total).tobytes(), dtype=np.uint8)
        return total

    def _sys_clock_gettime(self, clk, *_):
        import time
        return int(time.monotonic_ns() // 1000)  # usec

    def _sys_echo(self, a0, *_):
        return a0


def make_default_table(heap: HostHeap | None = None,
                       pool: MemoryPool | None = None) -> SyscallTable:
    heap = heap if heap is not None else HostHeap()
    pool = pool if pool is not None else MemoryPool()
    t = SyscallTable(heap, pool)
    t.register(Sys.OPEN, t._sys_open)
    t.register(Sys.CLOSE, t._sys_close)
    t.register(Sys.READ, t._sys_read)
    t.register(Sys.WRITE, t._sys_write)
    t.register(Sys.PREAD64, t._sys_pread)
    t.register(Sys.PWRITE64, t._sys_pwrite)
    t.register(Sys.SOCKET, t._sys_socket)
    t.register(Sys.BIND, t._sys_bind)
    t.register(Sys.SENDTO, t._sys_sendto)
    t.register(Sys.RECVFROM, t._sys_recvfrom)
    t.register(Sys.MMAP, t._sys_mmap)
    t.register(Sys.MUNMAP, t._sys_munmap)
    t.register(Sys.MADVISE, t._sys_madvise)
    t.register(Sys.GETRUSAGE, t._sys_getrusage)
    t.register(Sys.CLOCK_GETTIME, t._sys_clock_gettime)
    t.register(Sys.ECHO, t._sys_echo)
    t.register(Sys.PREAD64_FIXED, t._sys_pread_fixed)
    t.register(Sys.RECVFROM_FIXED, t._sys_recvfrom_fixed)
    t.register(Sys.PWRITE64_FIXED, t._sys_pwrite_fixed)
    t.register(Sys.SENDTO_FIXED, t._sys_sendto_fixed)
    return t

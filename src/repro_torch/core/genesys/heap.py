"""Host heap: the stand-in for the paper's shared virtual address space.

GENESYS passes syscall arguments as raw pointers into CPU/GPU-shared memory.
JAX device buffers have no stable host VA we may alias, so buffer arguments
are passed as *handles* into this registry instead: a handle is a u64 that
fits a syscall arg slot and resolves, on the host side, to a numpy buffer or
bytes object. This preserves the paper's calling convention (6 u64 args)
without pretending CPython has shared-VA semantics.

This dict-of-objects registry is the *legacy* data plane; the default is
:class:`repro_torch.core.genesys.arena.HostArena`, a subclass whose buffers are
extents of one registered ``np.uint8`` arena (zero-copy in-place
completions, lock-free resolve). ``HostHeap`` remains both the shim for
foreign/bytes objects and the baseline the arena is benchmarked against
(``benchmarks/fig15_zerocopy.py``).
"""
from __future__ import annotations

import threading
from typing import Any

import numpy as np


class HostHeap:
    def __init__(self):
        self._lock = threading.Lock()
        self._next = 1  # 0 is NULL
        self._objs: dict[int, Any] = {}

    def register(self, obj: Any) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._objs[h] = obj
            return h

    def resolve(self, handle: int) -> Any:
        with self._lock:
            return self._objs[int(handle)]

    def resolve_many(self, handles) -> dict[int, Any]:
        """Resolve a batch under ONE lock round (the genesys.fuse scatter
        path). Dead handles are simply absent from the returned dict —
        the caller sees the same KeyError it would get from resolve()."""
        with self._lock:
            objs = self._objs
            return {h: objs[h]
                    for h in (int(x) for x in handles) if h in objs}

    def release(self, handle: int) -> None:
        """Drop a handle. Idempotent by contract: releasing a dead (or
        never-registered) handle is a no-op, so completion paths and
        cleanup paths may both release without coordinating. Subclasses
        must preserve this."""
        with self._lock:
            self._objs.pop(int(handle), None)

    def register_bytes(self, data, path: str = "register") -> int:
        """Register a private mutable copy of ``data`` (bytes-like or a
        uint8 ndarray). ``path`` labels the marshalling copy for
        bytes-copied accounting (used by the arena subclass; the dict
        registry accepts and ignores it)."""
        if isinstance(data, np.ndarray):
            return self.register(data.reshape(-1).view(np.uint8).copy())
        return self.register(bytearray(data))

    def new_buffer(self, nbytes: int) -> int:
        return self.register(np.zeros(int(nbytes), dtype=np.uint8))

    def view(self, handle):
        """Arena fast-path probe: a live arena extent's ndarray view, or
        ``None``. The dict registry has no extents, so always ``None`` —
        callers fall through to the legacy resolve/copy path."""
        return None

    def locate(self, handle):
        """Arena extent descriptor ``(segment, offset, nbytes)`` or
        ``None`` (see :meth:`view`)."""
        return None

    @staticmethod
    def is_arena_handle(handle) -> bool:
        return False

    def __len__(self) -> int:
        with self._lock:
            return len(self._objs)

"""Completion futures and the completion queue (CQ) for ``genesys.uring``.

The ring path replaces the doorbell path's slot-state handshake (the GPU
spinning on FINISHED, paper Fig 4) with io_uring-style completion delivery:

  * every submission gets a :class:`Completion` future, so weak-ordered
    *blocking* calls (paper §8.3) can be reaped out of order — whoever
    holds the future waits on exactly that call, regardless of the order
    the executor finishes them in;
  * submissions that ask for a CQE additionally land in a fixed-capacity
    :class:`CompletionQueue` that a reaper drains in batches, mirroring
    io_uring's CQ ring (with an overflow backlog instead of dropped CQEs,
    like post-5.5 kernels).

Ring submissions use *non-blocking* area slots (PROCESSING -> FREE), so the
slot is recycled immediately; the return value travels in the completion,
not in the slot. That is what makes the ring interrupt- and
spin-on-slot-free: nothing ever waits on slot state.

Throughput note: Completions share ONE condition variable (per ring), so a
worker retiring a 64-entry bundle resolves 64 futures with one notify, not
64 Event.set() calls — per-call completion cost is a flag write.
"""
from __future__ import annotations

import threading
from collections import deque


class Completion:
    """Per-call future for a ring submission.

    ``user_data`` is the submission id (io_uring's u64 user_data);
    ``result()`` blocks until the executor resolves the call and returns
    the syscall return value. Futures from one ring share a condition
    variable; batch completion notifies it once per bundle.
    """

    __slots__ = ("user_data", "sysno", "_cond", "_done", "_ret")

    def __init__(self, user_data: int, sysno: int,
                 cond: threading.Condition | None = None):
        self.user_data = int(user_data)
        self.sysno = int(sysno)
        self._cond = cond if cond is not None else threading.Condition()
        self._done = False
        self._ret = 0

    def done(self) -> bool:
        return self._done

    def set_result(self, retval: int, notify: bool = True) -> None:
        """Resolve the future. ``notify=False`` lets a batch completer mark
        many futures and notify the shared condition once afterwards."""
        self._ret = int(retval)
        self._done = True
        if notify:
            with self._cond:
                self._cond.notify_all()

    def result(self, timeout: float | None = None) -> int:
        if self._done:                  # fast path, no lock
            return self._ret
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout=timeout):
                raise TimeoutError(
                    f"completion ud={self.user_data} "
                    f"sysno={self.sysno} timed out")
        return self._ret

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = f"done ret={self._ret}" if self._done else "pending"
        return f"Completion(ud={self.user_data}, sysno={self.sysno}, {state})"


class CompletionQueue:
    """Fixed-capacity MPMC ring of ``(user_data, retval)`` CQEs.

    Workers push as calls finish (completion order, NOT submission order);
    reapers pop in batches. A full ring never drops a CQE — overflow
    entries queue in a backlog and ``overflows`` counts them, so the fast
    path stays a bounded ring while correctness is unconditional.
    """

    def __init__(self, depth: int = 1024):
        self.depth = int(depth)
        self._buf: list[tuple[int, int] | None] = [None] * self.depth
        self._head = 0          # consumer index (monotonic)
        self._tail = 0          # producer index (monotonic)
        self._backlog: deque[tuple[int, int]] = deque()
        self.overflows = 0
        self.pushed = 0
        self.reaped = 0
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)

    def _push_locked(self, user_data: int, retval: int) -> None:
        # once anything overflowed, later CQEs must follow it into the
        # backlog or reap order would invert
        if self._backlog or self._tail - self._head >= self.depth:
            self._backlog.append((int(user_data), int(retval)))
            self.overflows += 1
        else:
            self._buf[self._tail % self.depth] = (int(user_data), int(retval))
            self._tail += 1
        self.pushed += 1

    def push(self, user_data: int, retval: int) -> None:
        with self._lock:
            self._push_locked(user_data, retval)
            self._nonempty.notify()

    def push_many(self, items) -> None:
        """Post a bundle's CQEs with one lock round and one wakeup."""
        if not items:
            return
        with self._lock:
            for ud, ret in items:
                self._push_locked(ud, ret)
            self._nonempty.notify()

    def __len__(self) -> int:
        with self._lock:
            return (self._tail - self._head) + len(self._backlog)

    def snapshot(self) -> dict:
        """Consistent counter read (one lock round — same discipline as
        trace.Counters.snapshot): pushed/reaped/overflows/pending."""
        with self._lock:
            return {"pushed": self.pushed, "reaped": self.reaped,
                    "overflows": self.overflows,
                    "pending": (self._tail - self._head) + len(self._backlog)}

    def reap(self, max_n: int = 64, timeout: float | None = None
             ) -> list[tuple[int, int]]:
        """Pop up to ``max_n`` CQEs in completion order; blocks up to
        ``timeout`` for the first one (None = wait forever, 0 = poll)."""
        out: list[tuple[int, int]] = []
        with self._lock:
            if self._tail == self._head and not self._backlog:
                if timeout == 0:
                    return out
                if not self._nonempty.wait_for(
                        lambda: self._tail != self._head or self._backlog,
                        timeout=timeout):
                    return out
            while len(out) < max_n:
                if self._tail != self._head:
                    ent = self._buf[self._head % self.depth]
                    self._buf[self._head % self.depth] = None
                    self._head += 1
                elif self._backlog:
                    ent = self._backlog.popleft()
                else:
                    break
                assert ent is not None
                out.append(ent)
            self.reaped += len(out)
            if (self._tail != self._head) or self._backlog:
                self._nonempty.notify()   # pass the baton to other reapers
        return out

"""Data pipeline: tokenized shard files read through GENESYS.

The loader issues *relaxed-consumer, non-blocking* pread prefetches (the
paper §4.1's "prefetch data using read system calls but may not use the
results immediately" example) several batches ahead, then blocks only on
the ticket of the batch actually consumed. Straggler mitigation re-issues
a read that misses its deadline (redundant read, first-completion-wins).

``use_ring=True`` prefetches through a dedicated genesys.sched ``prefetch``
tenant: each pread is an SQE on the tenant's private ring (a carved
partition of the slot area) whose Completion future is the per-batch wait
handle — no doorbell interrupt, no FINISHED-slot parking, and prefetch
backlog can neither exhaust the shared slot area nor crowd other tenants'
(e.g. a serving loop's) syscalls out of the reap order. The tenant is
deliberately low-priority / low-weight: prefetch is throughput work that
runs ahead of consumption, so it should lose reap-order ties to
latency-critical tenants.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.genesys import Genesys, Sys
from repro_torch.core.genesys.area import Ticket
from repro_torch.core.genesys.completion import Completion


def write_token_shard(path: str, tokens: np.ndarray) -> None:
    tokens.astype(np.uint32).tofile(path)


@dataclass
class _Pending:
    ticket: Ticket | None
    buf_handle: int
    issued_at: float
    offset: int
    nbytes: int
    fd: int = -1
    completion: Completion | None = None


class GenesysDataLoader:
    """Iterates (tokens, labels) batches of [batch, seq+1] uint32 tokens.

    Reads happen as GENESYS pread syscalls (non-blocking; the §8.3 drain/
    wait is per-ticket), `prefetch_depth` batches ahead.
    """

    def __init__(self, gsys: Genesys, paths: list[str], *, batch: int,
                 seq: int, prefetch_depth: int = 2,
                 straggler_deadline_s: float = 2.0, seed: int = 0,
                 use_ring: bool = False, tenant_name: str = "prefetch",
                 fuse: bool = True):
        self.gsys = gsys
        self.use_ring = use_ring
        # dedicated prefetch tenant: private ring/slots, background QoS
        # (low weight + negative priority: prefetch runs ahead of
        # consumption, so it should lose reap-order ties). fuse=True runs
        # the tenant's popped bundles through the genesys.fuse Coalescer:
        # prefetches of adjacent/overlapping shard regions (and straggler
        # double-reads landing in one bundle) merge into single preads,
        # with identical per-read retvals/bytes.
        self._tenant = (gsys.tenant(tenant_name, weight=0.5, priority=-1,
                                    fuse=fuse)
                        if use_ring else None)
        self.paths = list(paths)
        self.batch = batch
        self.seq = seq
        self.prefetch_depth = max(1, prefetch_depth)
        self.deadline = straggler_deadline_s
        self.rng = np.random.default_rng(seed)
        self._fds = []
        self._sizes = []
        for p in paths:
            ph = gsys.heap.register_bytes(p.encode())
            fd = gsys.call(Sys.OPEN, ph, os.O_RDONLY, 0)
            if fd < 0:
                raise FileNotFoundError(p)
            self._fds.append(fd)
            self._sizes.append(os.path.getsize(p))
        self._pending: list[_Pending] = []
        self._cursor = 0
        self.stats = {"reads": 0, "straggler_reissues": 0}
        for _ in range(self.prefetch_depth):
            self._issue()

    def _batch_bytes(self) -> int:
        return self.batch * (self.seq + 1) * 4

    def _issue(self) -> None:
        n = self._batch_bytes()
        f = self._cursor % len(self._fds)
        max_off = max(1, self._sizes[f] - n)
        offset = int(self.rng.integers(0, max_off)) // 4 * 4
        bh = self.gsys.heap.new_buffer(n)
        if self.use_ring:
            # tenant ring path: the Completion future is the wait handle,
            # so the slot retires immediately and data ownership rides the
            # CQE; QoS hooks (rate limit, WFQ) apply to the prefetch stream
            c = self._tenant.submit(
                [(Sys.PREAD64, self._fds[f], bh, n, offset)])[0]
            self._pending.append(_Pending(ticket=None, buf_handle=bh,
                                          issued_at=time.monotonic(),
                                          offset=offset, nbytes=n,
                                          fd=self._fds[f], completion=c))
        else:
            # blocking slot with DEFERRED wait: weak ordering + blocking in
            # the paper's taxonomy — the result is eventually consumed, so
            # the slot must hold FINISHED until we poll it (non-blocking
            # slots retire immediately and cannot deliver data ownership).
            t = self.gsys.call_async(Sys.PREAD64, self._fds[f], bh, n, offset)
            self._pending.append(_Pending(ticket=t, buf_handle=bh,
                                          issued_at=time.monotonic(),
                                          offset=offset, nbytes=n,
                                          fd=self._fds[f]))
        self._cursor += 1
        self.stats["reads"] += 1

    def _wait(self, p: _Pending) -> np.ndarray:
        t0 = time.monotonic()
        timed_out = False
        try:
            if p.completion is not None:
                p.completion.result(timeout=self.deadline)
            else:
                self.gsys.wait(p.ticket, timeout=self.deadline)
        except TimeoutError:
            timed_out = True
        # straggler mitigation: if the WAIT blew the deadline, re-issue the
        # read synchronously (redundant read, first completion wins)
        if timed_out or time.monotonic() - t0 > self.deadline:
            self.stats["straggler_reissues"] += 1
            self.gsys.call(Sys.PREAD64, p.fd, p.buf_handle,
                           p.nbytes, p.offset, blocking=True)
        buf = np.asarray(self.gsys.heap.resolve(p.buf_handle))
        # NOTE: this is a view into the handle's buffer — the caller
        # (next_batch) copies it out and only THEN releases the handle.
        # A released arena extent returns to the free list for re-carving,
        # so a view must never outlive its handle.
        return buf.view(np.uint32).reshape(self.batch, self.seq + 1)

    def next_batch(self) -> dict:
        """Returns {"tokens": [B,S] int32, "labels": [B,S] int32}."""
        p = self._pending.pop(0)
        self._issue()
        arr = self._wait(p).astype(np.int64)   # copies out of the buffer
        # release only after the copy; a straggling redundant read is
        # still safe: generation-tagged handles are never revived, so its
        # late dispatch resolves dead -> -EIO instead of touching anyone
        # else's re-carved extent
        self.gsys.heap.release(p.buf_handle)
        return {
            "tokens": arr[:, :-1].astype(np.int32),
            "labels": arr[:, 1:].astype(np.int32),
        }

    def close(self) -> None:
        self.gsys.drain()
        for fd in self._fds:
            self.gsys.call(Sys.CLOSE, fd)

"""CPU-side syscall processing: interrupts, worker threads, coalescing.

Mirrors the paper §5 'CPU-side system call processing':

  * the device "interrupts" the CPU, identifying the requesting slot
    (paper: hardware ID of the wavefront) — here a doorbell queue;
  * the interrupt handler creates a kernel task on a work-queue — here a
    bundle pushed to a worker thread pool;
  * coalescing: the dispatcher waits up to ``coalesce_window_us`` for more
    interrupts and merges up to ``coalesce_max`` requests into one bundle,
    which a single worker then processes *serially* (the paper's explicit
    latency/throughput trade-off);
  * the two knobs are the paper's sysfs parameters.

Polling mode (the ``genesys.uring`` path): :meth:`Executor.submit_bundle`
feeds an already-READY bundle straight onto the worker queue — no doorbell,
no dispatcher hop, one queue operation per *batch* instead of per call.
Doorbell and ring requests share the same worker pool, in-flight
accounting, and :meth:`drain` barrier; each bundle entry may carry a
completion callback, which is how the ring delivers CQEs.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.genesys.area import SyscallArea, SlotState
from repro_torch.core.genesys.syscalls import SyscallTable
from repro_torch.core.genesys.trace import (Counters, EV_COMPLETE, EV_DISPATCH,
                                      EV_IRQ)

# errno values shared by the retry/fault-injection machinery (admit.py,
# uring.py): handlers return -errno, so transient-vs-fatal classification
# happens on the negated dispatch result
EIO, EINTR, EAGAIN = 5, 4, 11


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff for *transient* dispatch errnos.

    A handler returning -EAGAIN/-EINTR is retried in place (same worker,
    same slot) up to ``max_retries`` times with exponential backoff
    starting at ``backoff_us``; anything else — including -EIO and
    handler exceptions — surfaces to the caller on the first attempt.
    Note socket-timeout polls map to -EIO (errno None), so idle recvfrom
    loops never enter the retry path."""
    max_retries: int = 3
    backoff_us: float = 50.0
    transient: frozenset = frozenset({EAGAIN, EINTR})


@dataclass
class ExecutorStats:
    interrupts: int = 0
    bundles: int = 0
    ring_bundles: int = 0
    processed: int = 0
    ring_processed: int = 0
    injected_faults: int = 0
    retries: int = 0
    retries_exhausted: int = 0
    coalesce_hist: dict = field(default_factory=dict)
    busy_s: float = 0.0

    def mean_coalesce(self) -> float:
        n = sum(self.coalesce_hist.values())
        if not n:
            return 0.0
        return sum(k * v for k, v in self.coalesce_hist.items()) / n


class Executor:
    def __init__(self, area: SyscallArea, table: SyscallTable, *,
                 n_workers: int = 2, coalesce_window_us: int = 0,
                 coalesce_max: int = 1):
        self.area = area
        self.table = table
        self.coalesce_window_us = int(coalesce_window_us)
        self.coalesce_max = max(1, int(coalesce_max))
        # stats are mutated from the dispatcher and every worker thread;
        # Counters is the one lock-consistent read-modify-write/snapshot
        # discipline shared by every genesys *Stats record (trace.py)
        self.counters = Counters(ExecutorStats())
        self.stats = self.counters.stats
        # doorbell-path trace channel (a trace.TraceChannel); None = off
        self.trace = None
        # deterministic fault injection (an admit.FaultPlan); None = off.
        # Every dispatch — ring, fused, and doorbell-fallback — funnels
        # through dispatch_call(), so one plan covers all three paths.
        self.fault_plan = None
        self.retry = RetryPolicy()
        self._doorbell: queue.Queue = queue.Queue()
        self._bundles: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Condition(self._inflight_lock)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="genesys-dispatch", daemon=True)
        self._workers = [
            threading.Thread(target=self._worker_loop,
                             name=f"genesys-worker-{i}", daemon=True)
            for i in range(max(1, n_workers))
        ]
        self._dispatcher.start()
        for w in self._workers:
            w.start()

    # -- device side: the interrupt -------------------------------------------
    def interrupt(self, slot: int, on_complete=None, area=None,
                  coalesce_max: int | None = None) -> None:
        """Device -> CPU doorbell (paper: s_sendmsg scalar instruction).
        ``on_complete(slot, retval)`` fires after the call is processed —
        the ring's SQ-full fallback uses it to keep CQE delivery uniform.
        ``area`` overrides the slot's home area (tenant-partition slots must
        retire to their partition's free list, not the parent's).
        ``coalesce_max`` is a per-call (tenant-scoped) bound on how many
        interrupts the dispatcher may coalesce into the bundle carrying
        this call — a latency tenant's doorbell fallback is never buried
        under a full ``coalesce_max``-deep bundle of batch traffic."""
        with self._inflight_lock:
            self._inflight += 1
        self.counters.add(interrupts=1)
        tr, tseq = self.trace, 0
        if tr is not None:
            # doorbell calls have no ring user_data; a tracer-allocated
            # seq threads IRQ -> DISPATCH -> COMPLETE through the bundle
            tseq = tr.next_seq()
            a = self.area if area is None else area
            tr.rec(EV_IRQ, int(a.slots[slot]["sysno"]), tseq)
        self._doorbell.put((slot, on_complete, area, coalesce_max, tseq))

    def add_inflight(self, n: int) -> None:
        """Account ring submissions the moment they land in the SQ, so
        drain() also covers entries the poller has not popped yet."""
        with self._inflight_lock:
            self._inflight += int(n)

    # -- polling mode: the ring's entry point -----------------------------------
    def submit_bundle(self, bundle, *, counted: bool = False) -> None:
        """Enqueue a polling-mode bundle directly on the worker pool,
        bypassing doorbell + dispatcher (one queue op per batch). A bundle
        is either a list of ``(slot, on_complete, area[, coalesce_max,
        tseq])`` tuples or an object with ``process(executor)`` that owns its own
        accounting (the ring's batch). ``counted=True`` means
        add_inflight() already ran."""
        if not len(bundle):
            return
        if not counted:
            self.add_inflight(len(bundle))
        self.counters.add(ring_bundles=1)
        self._bundles.put(bundle)

    # -- dispatcher: interrupt handler + coalescing -----------------------------
    @staticmethod
    def _item_cmax(item) -> int | None:
        return item[3] if len(item) > 3 else None

    def _dispatch_loop(self) -> None:
        carry = None        # item that refused to join the previous bundle
        while not self._stop.is_set():
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._doorbell.get(timeout=0.05)
                except queue.Empty:
                    continue
            bundle = [first]
            # the bundle bound is the min of the global sysfs knob and
            # every member's tenant-scoped coalesce_max
            limit = self.coalesce_max
            cmax = self._item_cmax(first)
            if cmax is not None:
                limit = min(limit, max(1, int(cmax)))
            if limit > 1 and self.coalesce_window_us > 0:
                deadline = time.monotonic() + self.coalesce_window_us / 1e6
                while len(bundle) < limit:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        item = self._doorbell.get(timeout=remaining)
                    except queue.Empty:
                        break
                    cmax = self._item_cmax(item)
                    if cmax is not None and int(cmax) <= len(bundle):
                        # joining would already blow this item's own bound:
                        # it starts the NEXT bundle instead
                        carry = item
                        break
                    bundle.append(item)
                    if cmax is not None:
                        limit = min(limit, max(1, int(cmax)))
            k = len(bundle)

            def _acct(s, k=k):
                s.bundles += 1
                s.coalesce_hist[k] = s.coalesce_hist.get(k, 0) + 1
            self.counters.update(_acct)
            self._bundles.put(bundle)

    # -- worker: Linux workqueue task -------------------------------------------
    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                bundle = self._bundles.get(timeout=0.05)
            except queue.Empty:
                continue
            t0 = time.monotonic()
            if hasattr(bundle, "process"):     # polling-mode batch (ring)
                bundle.process(self)
            else:
                for slot, on_complete, area, *rest in bundle:  # serial (§4.2)
                    self._process(slot, on_complete, area,
                                  tseq=rest[1] if len(rest) > 1 else 0)
            dt = time.monotonic() - t0
            self.counters.add(busy_s=dt)

    def dispatch_call(self, sysno: int, args, owner=None) -> int:
        """The one dispatch funnel: fault injection, then the table, then
        bounded retry-with-backoff for transient errnos. ``owner`` is the
        tenant name the call was submitted under (None for the global
        ring/doorbell) — fault plans key their schedules on it. Both the
        ring batch paths and the doorbell fallback call this, so a
        transient -EAGAIN on *any* path consumes the same retry budget
        instead of surfacing straight to the caller."""
        sysno = int(sysno)
        # per-tenant bytes-copied attribution rides worker TLS: handlers
        # call note_copy() without owner plumbed through every signature
        self.table._copy_tls.owner = owner
        plan, rp = self.fault_plan, self.retry
        attempt = 0
        while True:
            inj = plan.check(owner, sysno) if plan is not None else 0
            if inj:
                self.counters.add(injected_faults=1)
                ret = -inj
            else:
                try:
                    ret = self.table.dispatch(sysno, args)
                except Exception:        # non-OSError handler failure: the
                    ret = -5             # caller sees -EIO, the worker
                    return ret           # thread stays healthy; never retry
            if ret < 0 and -ret in rp.transient:
                if attempt < rp.max_retries:
                    attempt += 1
                    self.counters.add(retries=1)
                    if rp.backoff_us > 0:
                        time.sleep(rp.backoff_us * (1 << (attempt - 1)) / 1e6)
                    continue
                self.counters.add(retries_exhausted=1)
            return ret

    def _process(self, slot: int, on_complete=None, area=None,
                 tseq: int = 0) -> None:
        area = self.area if area is None else area
        try:
            if not area.claim_for_processing(slot):
                return  # raced / cancelled
            rec = area.slots[slot]
            tr = self.trace
            sysno = int(rec["sysno"])
            if tr is not None and tseq:
                tr.rec(EV_DISPATCH, sysno, tseq, aux=tr.thread_aux())
            ret = self.dispatch_call(sysno, rec["args"],
                                     getattr(area, "owner", None))
            area.complete(slot, ret)
            # counters before on_complete: on_complete pushes the CQE, so
            # a snapshot can never observe more reaped than processed
            if on_complete is not None:
                self.counters.add(processed=1, ring_processed=1)
            else:
                self.counters.add(processed=1)
            if tr is not None and tseq:
                tr.rec(EV_COMPLETE, sysno, tseq)
            if on_complete is not None:
                on_complete(slot, ret)
        finally:
            with self._inflight_lock:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.notify_all()

    # -- §8.3: the completion barrier --------------------------------------------
    def drain(self, timeout: float | None = 30.0) -> None:
        """Block until every issued syscall has completed (the paper's new
        CPU-invoked call that 'ensures all GPU system calls have completed').
        Covers doorbell interrupts AND ring submissions, including SQ
        entries the poller has not yet popped."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._inflight_lock:
            while self._inflight > 0:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise TimeoutError(
                        f"drain: {self._inflight} syscalls still in flight")
                self._idle.wait(timeout=rem)

    def shutdown(self) -> None:
        self.drain()
        self._stop.set()
        self._dispatcher.join(timeout=2)
        for w in self._workers:
            w.join(timeout=2)

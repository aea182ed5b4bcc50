"""genesys.uring: shared-memory submission/completion rings for
interrupt-free GPU syscalls.

The paper's CPU path (§5) takes a doorbell interrupt per syscall and turns
it into a work-queue task; §6 measures the latency/throughput trade-off of
coalescing those interrupts. This module is the io_uring-shaped answer to
the same bottleneck: the device posts submission-queue entries (SQEs) into
a fixed-capacity shared-memory ring, and a host-side poller (a
single-member :class:`~repro_torch.core.genesys.sched.PollerGroup`)
discovers them by polling — no per-call doorbell, no per-call queue hop.

Layout (mirrors io_uring, adapted to the GENESYS slot area):

  * the *payload* of each call still lives in a 64-byte
    :class:`~repro_torch.core.genesys.area.SyscallArea` slot (sysno, six u64
    args) — the SQE is just ``(slot index, user_data, flags)``, like
    io_uring SQEs referencing registered buffers;
  * SQ: fixed-capacity ring of SQEs with monotonically increasing
    head/tail, so wraparound is index arithmetic, never data movement;
  * CQ: see :mod:`repro_torch.core.genesys.completion` — per-call
    :class:`Completion` futures (out-of-order reap of weak-ordered
    blocking calls, paper §8.3) plus an optional CQE ring;
  * SQ-full backpressure (``sq_full=``): ``"spin"`` busy-waits for space
    and falls back to the doorbell path if the wait blows its bound;
    ``"doorbell"`` falls back immediately; ``"raise"`` demands the whole
    batch fit up front and raises :class:`RingFull` otherwise;
  * the poller adaptively sleeps when the SQ stays empty, using the
    io_uring SQPOLL ``need_wakeup`` protocol: it parks on an event and
    submitters deliver exactly one wakeup on the empty->nonempty edge
    (an edge-triggered interrupt per *idle period*, not per call).

Why the ring is fast: every per-call lock/CAS/notify of the doorbell path
is batched to once per bundle. Submission acquires+populates all slots in
one area-lock round and publishes SQEs in one SQ-lock round; the worker
claims, dispatches, retires, and resolves a whole bundle with one lock
round per structure (area, completion registry, CQ) and ONE condition
wakeup. Per-call cost collapses to the payload write + handler dispatch.

Ring submissions always use non-blocking area slots: the slot recycles the
moment the handler returns (PROCESSING -> FREE) and the return value
travels in the Completion/CQE. Nothing ever spins on slot state, which is
why the ring path needs neither interrupts nor the FINISHED handshake.

Data plane: buffer args in SQE payloads are heap handles. Under the
default registered arena (genesys.arena) a handle IS a FIXED-style
reference — generation-tagged extent index in one u64 — so every ring
call gets registered-buffer addressing (lock-free resolve, in-place
completion) without the explicit ``register_buffers()`` step; the
``*_FIXED`` sysnos (including the gather-side ``PWRITE64_FIXED`` /
``SENDTO_FIXED``) remain for pinned table indices.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np

from repro_torch.core.genesys.area import SyscallArea
from repro_torch.core.genesys.completion import Completion, CompletionQueue
from repro_torch.core.genesys.executor import Executor
from repro_torch.core.genesys.trace import (Counters, EV_COMPLETE, EV_DISPATCH,
                                      EV_FALLBACK, EV_REAP, EV_SQ_POP,
                                      EV_SUBMIT)

SQE_WANT_CQE = 0x1     # post a CQE to the CQ ring (besides the future)


class RingFull(RuntimeError):
    """SQ has no free entries and the chosen backpressure policy gave up."""


@dataclass
class RingStats:
    submitted: int = 0          # SQEs that entered the SQ
    fallback_doorbell: int = 0  # SQ-full submissions routed via interrupt
    sq_full_spins: int = 0      # times a submitter had to spin for space
    bundles: int = 0            # batches handed to the executor
    polls: int = 0              # non-empty SQ polls
    empty_polls: int = 0        # poller visits that found the SQ empty
    credit_stalls: int = 0      # poller visits skipped: CQ reap credit gone
    # (park/wakeup counts live on the poller: sched.SchedStats.wakeups)
    batch_hist: dict = field(default_factory=dict)

    def mean_batch(self) -> float:
        n = sum(self.batch_hist.values())
        if not n:
            return 0.0
        return sum(k * v for k, v in self.batch_hist.items()) / n


class _Popped(list):
    """A popped bundle (list of SQE tuples) that can carry the tracer's
    per-bundle column arrays so downstream DISPATCH/COMPLETE records
    reuse them instead of rebuilding from the tuples."""

    __slots__ = ("trace_cols",)


class _RingBatch:
    """A popped bundle of SQEs; the executor worker runs :meth:`process`.

    Implements the executor's polling-mode bundle protocol (any object
    with a ``process(executor)`` method): claim all slots, dispatch each
    call serially (submission order within the bundle), retire all slots,
    resolve all futures, post all CQEs — one lock round per structure.
    """

    __slots__ = ("ring", "entries")

    def __init__(self, ring: SyscallRing, entries):
        self.ring = ring
        self.entries = entries      # list of (slot, user_data, flags, sysno)

    def __len__(self) -> int:
        return len(self.entries)

    def qos_entries(self):
        """What the scheduler should charge for this batch: one entry per
        actual kernel crossing. An unfused batch crosses once per entry."""
        return self.entries

    def process(self, ex: Executor) -> None:
        ring = self.ring
        # the ring's area, not the executor's: tenant rings run over a
        # carved partition whose slots must retire to their own free list
        area = ring.area
        slots = [e[0] for e in self.entries]
        n = len(slots)
        tr = ring.trace
        tr_sys = tr_ud = None
        if tr is not None:
            # shared by DISPATCH and COMPLETE (staged by reference via
            # own=True; never mutated): the pop's columns when available
            cols = getattr(self.entries, "trace_cols", None)
            if cols is not None:
                tr_sys, tr_ud = cols
            else:
                tr_sys = [e[3] for e in self.entries]
                tr_ud = [e[1] for e in self.entries]
        try:
            if tr is not None:
                tr.rec_block(EV_DISPATCH, tr_sys, tr_ud,
                             aux=tr.thread_aux(), own=True)
            area.claim_many(slots)
            recs = area.slots
            owner = ring.owner
            rets = []
            for slot in slots:
                rec = recs[slot]
                # the one dispatch funnel: fault injection + bounded retry
                # for transient errnos; exceptions net to -EIO inside, so
                # the worker and the bundle stay alive
                rets.append(ex.dispatch_call(rec["sysno"], rec["args"],
                                             owner))
            area.complete_many(slots, rets)
            # counters + COMPLETE events before futures/CQEs become
            # visible, so a snapshot can never show reaped > processed
            ex.counters.add(processed=n, ring_processed=n)
            if tr is not None:
                tr.rec_block(EV_COMPLETE, tr_sys, tr_ud, own=True)
            ring._complete_batch(self.entries, rets)
        finally:
            # mirror _process(): in-flight accounting survives any failure,
            # so drain()/shutdown() can never hang on a dead bundle
            with ex._inflight_lock:
                ex._inflight -= n
                if ex._inflight == 0:
                    ex._idle.notify_all()


class SyscallRing:
    """Submission/completion rings over a :class:`SyscallArea` + executor.

    ``sq_depth`` bounds in-flight-but-unpolled submissions;
    ``batch_max`` bounds how many SQEs one poll turns into one executor
    bundle (the ring-path analogue of the paper's ``coalesce_max``).
    """

    def __init__(self, area: SyscallArea, executor: Executor, *,
                 sq_depth: int = 256, cq_depth: int = 1024,
                 batch_max: int = 64, spin_polls: int = 64,
                 max_sleep_s: float = 0.002, start_poller: bool = True,
                 fuse=None, fallback_coalesce_max: int | None = None):
        self.area = area
        self.executor = executor
        self.sq_depth = int(sq_depth)
        self.batch_max = max(1, int(batch_max))
        # genesys.fuse: optional cross-call Coalescer pre-pass; popped
        # bundles route through it in dispatch_entries (see fuse.py)
        self.fuse = fuse
        # per-tenant interrupt-coalescing bound for SQ-full doorbell
        # fallbacks (the paper's coalesce_max sysfs knob, tenant-scoped)
        self.fallback_coalesce_max = fallback_coalesce_max
        self.cq = CompletionQueue(cq_depth)
        self.counters = Counters(RingStats())
        self.stats = self.counters.stats
        # lifecycle trace channel (a trace.TraceChannel); None = off
        self.trace = None
        # owning tenant's name (set by Tenant); fault plans key their
        # errno schedules on it, None = the global/unowned ring
        self.owner = None
        # SQ ring: slot index + user_data + flags + sysno per entry
        # ("shared memory"; sysno rides along so pollers can do per-sysno
        # QoS cost accounting without touching the slot area)
        self._sq_slot = np.full(self.sq_depth, -1, dtype=np.int64)
        self._sq_ud = np.zeros(self.sq_depth, dtype=np.int64)
        self._sq_flags = np.zeros(self.sq_depth, dtype=np.uint32)
        self._sq_sysno = np.zeros(self.sq_depth, dtype=np.int64)
        self._sq_head = 0           # consumer (poller), monotonic
        self._sq_tail = 0           # producer (device side), monotonic
        self._sq_reserved = 0       # space promised to sq_full="raise" batches
        self._sq_lock = threading.Lock()
        # SQPOLL-style wakeup protocol
        self._need_wakeup = False
        self._wakeup = threading.Event()
        # completion registry; all futures share one condition (see
        # completion.py throughput note)
        self._next_ud = 1
        self._completions: dict[int, Completion] = {}
        self._comp_lock = threading.Lock()
        self._comp_cond = threading.Condition()
        # the reaper is a single-member PollerGroup (genesys.sched); tenant
        # rings pass start_poller=False and are reaped by a shared group
        # instead, so they get no private poller at all
        if start_poller:
            from repro_torch.core.genesys.sched import PollerGroup
            self.poller = PollerGroup(self, spin_polls=spin_polls,
                                      max_sleep_s=max_sleep_s)
            self.poller.start()
        else:
            self.poller = None

    @property
    def _stats_lock(self):
        """The stats lock IS the Counters lock: every RingStats mutation
        and snapshot shares one lock, so reads are never torn. Assignable
        so tests can interpose a spy lock."""
        return self.counters.lock

    @_stats_lock.setter
    def _stats_lock(self, lock) -> None:
        self.counters.lock = lock

    # -- submission (device side) ---------------------------------------------
    def submit_many(self, calls, *, want_cqe: bool = False, hw_id: int = 0,
                    sq_full: str = "spin", spin_timeout_s: float = 5.0,
                    fallback_out: list | None = None) -> list[Completion]:
        """Post a batch of ``(sysno, *args)`` calls; returns one
        :class:`Completion` per call, in submission order.

        ``sq_full`` picks the backpressure policy when the SQ lacks space:
        ``"spin"`` (bounded busy-wait, then doorbell fallback), ``"doorbell"``
        (immediate fallback to the interrupt path — calls still complete
        through the same futures/CQ), or ``"raise"`` (:class:`RingFull`
        unless the whole batch fits up front; nothing is submitted).

        ``fallback_out``: optional list this call appends ITS OWN doorbell
        fallback count to — per-submission attribution (QoS accounting
        needs exactly this submission's overflow, which the shared
        aggregate ``stats.fallback_doorbell`` counter by definition does
        not break out; snapshot reads of the aggregate are consistent —
        every mutation and read goes through ``counters``'s one lock).
        """
        n = len(calls)
        if n == 0:
            return []
        sysnos = np.zeros(n, dtype=np.int64)
        args = np.zeros((n, 6), dtype=np.uint64)
        for i, c in enumerate(calls):
            sysnos[i] = int(c[0])
            rest = c[1:]
            for j in range(min(6, len(rest))):
                args[i, j] = int(rest[j]) & 0xFFFFFFFFFFFFFFFF
        return self._submit_arrays(sysnos, args, want_cqe=want_cqe,
                                   hw_id=hw_id, sq_full=sq_full,
                                   spin_timeout_s=spin_timeout_s,
                                   fallback_out=fallback_out)

    def submit_np(self, sysno, args: np.ndarray, *, want_cqe: bool = False,
                  hw_id: int = 0, sq_full: str = "spin",
                  spin_timeout_s: float = 5.0) -> list[Completion]:
        """Array-native submission: ``args`` is ``[n, 6]`` uint64 (e.g. the
        vectorized arg-join of a WORK_ITEM batch, invoke._np_join_batch);
        ``sysno`` is a scalar or an ``[n]`` array. Skips all per-call tuple
        and int churn — the whole batch goes slot-ward as two arrays."""
        args = np.ascontiguousarray(args, dtype=np.uint64)
        n = len(args)
        if n == 0:
            return []
        if np.ndim(sysno) == 0:
            sysnos = np.full(n, int(sysno), dtype=np.int64)
        else:
            sysnos = np.asarray(sysno, dtype=np.int64)
        return self._submit_arrays(sysnos, args, want_cqe=want_cqe,
                                   hw_id=hw_id, sq_full=sq_full,
                                   spin_timeout_s=spin_timeout_s)

    def _submit_arrays(self, sysnos: np.ndarray, args: np.ndarray, *,
                       want_cqe: bool, hw_id: int, sq_full: str,
                       spin_timeout_s: float,
                       fallback_out: list | None = None
                       ) -> list[Completion]:
        n = len(sysnos)
        reserved = sq_full == "raise"
        if reserved:
            # atomic check-and-reserve: concurrent raise-batches can never
            # both pass a stale space check, and spin/doorbell submitters
            # cannot steal the promised space before we publish into it
            with self._sq_lock:
                avail = (self.sq_depth - (self._sq_tail - self._sq_head)
                         - self._sq_reserved)
                if avail < n:
                    raise RingFull(
                        f"SQ has {avail}/{self.sq_depth} free, need {n}")
                self._sq_reserved += n
        flags = SQE_WANT_CQE if want_cqe else 0
        comps: list[Completion] = []
        published = 0
        fell_back = 0
        try:
            # chunk acquire->publish so a huge batch never sits on
            # unpublished (hence unprocessable) slots while waiting for the
            # area to free — acquiring the whole area up front would
            # deadlock against itself
            chunk = max(1, min(self.sq_depth, self.area.n_slots // 2))
            for lo in range(0, n, chunk):
                k = min(chunk, n - lo)
                slot_arr = self.area.acquire_post_np(
                    sysnos[lo:lo + k], args[lo:lo + k], hw_id=hw_id)
                part_sys = sysnos[lo:lo + k].tolist()
                with self._comp_lock:
                    ud0 = self._next_ud
                    self._next_ud += k
                    cs = [Completion(ud0 + i, part_sys[i], self._comp_cond)
                          for i in range(k)]
                    for c in cs:
                        self._completions[c.user_data] = c
                # entries travel as a [k, 4] int64 matrix so the SQ publish
                # is pure numpy segment copies (list-of-tuples only
                # materializes on pop, where consumers want Python ints)
                entries = np.empty((k, 4), dtype=np.int64)
                entries[:, 0] = slot_arr
                entries[:, 1] = np.arange(ud0, ud0 + k, dtype=np.int64)
                entries[:, 2] = flags
                entries[:, 3] = sysnos[lo:lo + k]
                tr = self.trace
                if tr is not None:
                    # keyed by user_data: the seq every later lifecycle
                    # event (pop/dispatch/complete/reap) carries. own=True:
                    # this chunk matrix is local and never written again.
                    # aux carries the submitting thread's request-span id
                    # (0 = none) so request-scoped tracing can attribute
                    # every syscall to the serving request that caused it
                    tr.rec_block(EV_SUBMIT, entries[:, 3], entries[:, 1],
                                 aux=tr.span_aux(), own=True)
                fell_back += self._publish(entries, sq_full, spin_timeout_s,
                                           reserved=reserved)
                published += k
                comps += cs
        finally:
            if reserved and published < n:
                # an exception mid-batch must hand back the unconsumed
                # reservation, or it shrinks every future submitter's SQ
                with self._sq_lock:
                    self._sq_reserved -= n - published
        if fallback_out is not None:
            fallback_out.append(fell_back)
        return comps

    def submit(self, sysno, *args, want_cqe: bool = False, hw_id: int = 0
               ) -> Completion:
        return self.submit_many([(sysno, *args)], want_cqe=want_cqe,
                                hw_id=hw_id)[0]

    def _publish(self, entries, sq_full: str, spin_timeout_s: float,
                 reserved: bool = False) -> int:
        """Move entries into the SQ (bulk), applying backpressure policy.
        ``reserved=True`` means this batch holds a ``_sq_reserved`` claim
        (sq_full="raise"): its pushes draw down the reservation. Returns
        how many entries fell back to the doorbell path (0 = all rang)."""
        i = 0
        n = len(entries)
        deadline = None
        while i < n:
            i += self._sq_push_bulk(entries[i:], reserved=reserved)
            if i >= n:
                return 0
            if sq_full == "doorbell":
                break
            # spin: bounded busy-wait for the poller to free SQ space
            if deadline is None:
                self.counters.add(sq_full_spins=1)
                deadline = time.monotonic() + spin_timeout_s
            if time.monotonic() > deadline:
                break                  # blew the bound -> doorbell fallback
            time.sleep(0)              # yield the GIL to the poller/workers
        fell_back = len(entries) - i
        if fell_back:
            self.counters.add(fallback_doorbell=fell_back)
            tr = self.trace
            if tr is not None:
                tr.rec_block(EV_FALLBACK, entries[i:, 3], entries[i:, 1])
            for slot, ud, fl, _sysno in entries[i:]:
                self.executor.interrupt(
                    int(slot),
                    partial(self._complete, int(ud),
                            bool(int(fl) & SQE_WANT_CQE)),
                    area=self.area,
                    coalesce_max=self.fallback_coalesce_max)
        return fell_back

    def _sq_push_bulk(self, entries, reserved: bool = False) -> int:
        """Publish as many SQEs as fit, one lock round. Returns count.

        ``entries`` is a ``[k, 4]`` int64 matrix (or anything np.asarray
        can shape that way); the copy into the SQ arrays is two contiguous
        numpy segment writes (pre- and post-wraparound), not a per-entry
        Python loop. ``reserved=True`` pushes consume the caller's own
        ``_sq_reserved`` claim; unreserved pushes must leave reserved
        space untouched."""
        arr = np.asarray(entries, dtype=np.int64)
        # pre-account the attempt and reconcile the shortfall after:
        # submitted only ever leads the SQ (never trails), so a concurrent
        # snapshot can never observe processed > submitted. Both writes sit
        # outside _sq_lock (no nested-lock stats mutation), and in the
        # common all-fit case this is one _stats_lock round, same as before.
        self.counters.add(submitted=len(arr))
        wake = False
        with self._sq_lock:
            avail = self.sq_depth - (self._sq_tail - self._sq_head)
            if not reserved:
                avail -= self._sq_reserved
            k = min(len(arr), max(0, avail))
            if k and reserved:
                self._sq_reserved -= k
            if k:
                pos = self._sq_tail % self.sq_depth
                first = min(k, self.sq_depth - pos)
                for col, dst in ((0, self._sq_slot), (1, self._sq_ud),
                                 (3, self._sq_sysno)):
                    dst[pos:pos + first] = arr[:first, col]
                    dst[:k - first] = arr[first:k, col]
                self._sq_flags[pos:pos + first] = arr[:first, 2]
                self._sq_flags[:k - first] = arr[first:k, 2]
                self._sq_tail += k
                # in-flight from the instant they are visible in the SQ,
                # so drain() covers entries the poller has not seen yet
                self.executor.add_inflight(k)
                if self._need_wakeup:
                    self._need_wakeup = False
                    wake = True
        if k < len(arr):
            # hand back the pre-account for entries that did not fit (the
            # caller will retry them or route them to the doorbell path)
            self.counters.add(submitted=k - len(arr))
        if wake:
            self._wakeup.set()
        return k

    # -- polling (host side) ---------------------------------------------------
    def pop_entries(self, max_n: int | None = None) -> list:
        """Pop up to ``max_n`` SQEs off the SQ in one lock round. Returns
        the raw ``(slot, user_data, flags, sysno)`` entries so a poller can
        inspect them (per-sysno QoS accounting) before dispatching them via
        :meth:`dispatch_entries`."""
        max_n = self.batch_max if max_n is None else int(max_n)
        with self._sq_lock:
            n = min(max_n, self._sq_tail - self._sq_head)
            if n == 0:
                return []
            pos = self._sq_head % self.sq_depth
            first = min(n, self.sq_depth - pos)
            cols = []
            for src in (self._sq_slot, self._sq_ud, self._sq_flags,
                        self._sq_sysno):
                col = src[pos:pos + first].tolist()
                if first < n:
                    col += src[:n - first].tolist()
                cols.append(col)
            self._sq_slot[pos:pos + first] = -1
            self._sq_slot[:n - first] = -1
            self._sq_head += n
        entries = _Popped(zip(*cols))

        def _acct(s, n=n):
            s.polls += 1
            s.bundles += 1
            s.batch_hist[n] = s.batch_hist.get(n, 0) + 1
        self.counters.update(_acct)
        tr = self.trace
        if tr is not None:
            # the pop's own column lists, shared (never mutated) by this
            # SQ_POP record and the batch's DISPATCH/COMPLETE records —
            # zero per-event work here; numpy conversion happens lazily
            # on the telemetry read path
            entries.trace_cols = (cols[3], cols[1])
            tr.rec_block(EV_SQ_POP, cols[3], cols[1],
                         aux=tr.thread_aux(), own=True)
        return entries

    def reap_credit(self) -> int:
        """The bounded reap-credit ledger (per-tenant CQ backpressure,
        closing PR 3's open item): how many more CQEs this ring's consumer
        has *room* to absorb before the CQ would spill into the unbounded
        backlog. Pollers serving tenant rings clamp their pop quantum to
        this, so a slow reaper's ring stalls at ~``cq_depth`` outstanding
        completions instead of growing a backlog forever — and instead of
        wedging the :class:`~repro_torch.core.genesys.sched.PollerGroup`, which
        simply skips the ring until the reaper drains credit back.
        Calls that never asked for CQEs consume no credit."""
        cq = self.cq
        with cq._lock:
            pending = (cq._tail - cq._head) + len(cq._backlog)
        return cq.depth - pending

    def plan(self, entries):
        """Build the dispatchable batch for one popped bundle — the fuse
        pre-pass happens here. The returned batch exposes
        ``qos_entries()``: the entries the scheduler should charge, one
        per actual kernel crossing (a fused read group charges once,
        not per member)."""
        if self.fuse is not None:
            return self.fuse.bundle(self, entries)
        return _RingBatch(self, entries)

    def dispatch_batch(self, batch, *, inline: bool = False) -> None:
        """Run a planned batch. ``inline=False`` hands it to the executor
        worker pool (one queue op); ``inline=True`` processes it on the
        calling thread — io_uring SQPOLL's do-the-work-in-the-poller mode,
        which keeps a latency tenant's calls out of the shared worker
        queue entirely (see genesys.sched)."""
        if not len(batch):
            return
        if inline:
            ex = self.executor
            ex.counters.add(ring_bundles=1)
            batch.process(ex)
        else:
            self.executor.submit_bundle(batch, counted=True)

    def dispatch_entries(self, entries, *, inline: bool = False) -> None:
        """Plan + run one popped bundle (see :meth:`plan` /
        :meth:`dispatch_batch`; split so the PollerGroup can read the
        planned batch's fuse-aware QoS charges before dispatching).

        Rings with a :class:`~repro_torch.core.genesys.fuse.Coalescer` attached
        (``fuse=``) get the cross-call fusion pre-pass here — the step
        between pop and dispatch — so both the PollerGroup reap path and
        direct process_pending() callers get semantic coalescing."""
        if not len(entries):
            return
        self.dispatch_batch(self.plan(entries), inline=inline)

    def process_pending(self, max_n: int | None = None, *,
                        inline: bool = False) -> int:
        """Pop up to ``max_n`` SQEs and run them as one bundle. Returns how
        many were popped. (The poller's unit of work; also callable
        directly, e.g. from tests or a caller-owned loop.)"""
        entries = self.pop_entries(max_n)
        self.dispatch_entries(entries, inline=inline)
        return len(entries)

    # -- completion plumbing ---------------------------------------------------
    def _complete_batch(self, entries, rets) -> None:
        """Worker side: resolve a bundle's futures (one registry lock round,
        one condition wakeup) and post its CQEs (one CQ lock round)."""
        with self._comp_lock:
            comps = [self._completions.pop(e[1], None) for e in entries]
        for c, ret in zip(comps, rets):
            if c is not None:
                c.set_result(ret, notify=False)
        with self._comp_cond:
            self._comp_cond.notify_all()
        cqes = [(e[1], ret) for e, ret in zip(entries, rets)
                if e[2] & SQE_WANT_CQE]
        self.cq.push_many(cqes)

    def _complete(self, ud: int, want_cqe: bool, slot: int, retval: int
                  ) -> None:
        """Per-call completion callback (doorbell-fallback path only)."""
        with self._comp_lock:
            comp = self._completions.pop(ud, None)
        tr = self.trace
        if tr is not None:
            # pairs with this call's SUBMIT (same user_data), closing the
            # "total" stage even though the call detoured via the doorbell
            tr.rec(EV_COMPLETE, comp.sysno if comp is not None else -1, ud)
        if comp is not None:
            comp.set_result(retval)
        if want_cqe:
            self.cq.push(ud, retval)

    # -- reaping ---------------------------------------------------------------
    def reap(self, max_n: int = 64, timeout: float | None = None
             ) -> list[tuple[int, int]]:
        """Drain up to ``max_n`` CQEs (completion order — out-of-order
        relative to submission)."""
        cqes = self.cq.reap(max_n, timeout=timeout)
        tr = self.trace
        if tr is not None and cqes:
            # a CQE carries only (user_data, retval); sysno attribution
            # comes from the COMPLETE side of the pair at analysis time
            tr.rec_block(EV_REAP, -1, [c[0] for c in cqes], own=True)
        return cqes

    def sq_space(self) -> int:
        with self._sq_lock:
            return self.sq_depth - (self._sq_tail - self._sq_head)

    def close(self) -> None:
        """Stop the private poller (if this ring owns one; rings reaped by
        a shared PollerGroup must be removed from it by their owner), then
        flush any SQEs nobody saw onto the worker pool — submissions
        racing with close() still complete, and a subsequent executor
        drain()/shutdown() cannot hang on in-flight counts for entries
        nobody would ever pop."""
        if self.poller is not None:
            self.poller.stop()
        while self.process_pending():
            pass


# The host-side poller lives in repro_torch.core.genesys.sched: ``PollerGroup``
# (N poller threads over M rings, QoS-ordered) replaced the original
# single-ring ``RingPoller``, which survives there as the one-ring,
# one-thread special case.

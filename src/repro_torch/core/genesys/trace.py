"""genesys.trace: end-to-end syscall lifecycle telemetry.

The paper's whole analysis (§6, Figs 5-10) is *measured* per-syscall
latency across the submit -> dispatch -> complete -> reap lifecycle; the
count-only ``*Stats`` dataclasses scattered across the genesys modules
cannot answer "where did this pread's 80µs go?", nor produce the
per-tenant p99s the SLO-admission direction (RTGPU) needs as its input
signal. This module is that measurement layer:

  * :class:`EventRing` — a fixed-capacity wraparound ring of 32-byte
    timestamped lifecycle events (numpy structured array). Appends are
    block-grain: one lock round publishes a whole bundle's events with
    numpy segment writes, so the hot-path cost is amortized exactly like
    the SQ publish it shadows. When the ring wraps, old events are
    overwritten and telemetry degrades to pure counters — tracing never
    blocks or grows.
  * :class:`Tracer` / :class:`TraceChannel` — the recorder. Channels are
    interned (tenant name -> small id) so an event is four scalars and an
    id, never a string. Every lifecycle event is keyed by
    ``(channel, sysno, seq)`` where ``seq`` is the ring's ``user_data``
    (or a tracer-allocated id on the doorbell path), so a call's full
    span is reconstructible.
  * :func:`latency_histograms` — vectorized log2-bucket latency
    histograms per (tenant, sysno, stage), computed with numpy from the
    event ring: pair matching is one ``np.intersect1d`` per stage, and
    ``count``/``p50``/``p99``/``max`` come from bucket cumsums — no
    per-call Python, no per-call timing state.
  * :meth:`Tracer.export_chrome_trace` — Chrome-trace/Perfetto JSON:
    rings, pollers, workers, and tenants as tracks, per-call spans, and
    fused bundles as attributed group spans.
  * :class:`Counters` — the one lock-consistent counter helper behind
    every ``*Stats`` dataclass (executor, ring, sched, fuse, tenant,
    syscall table). ``snapshot()`` reads all fields under the same lock
    every ``add()`` takes, so a concurrent reader can never see a torn
    or partially-updated stats record.

Tracing is OFF by default (``GenesysConfig.trace`` /
``Genesys.tenant(name, trace=True)``); every instrumentation site is a
single ``is not None`` check when disabled.

Event vocabulary (the lifecycle, ring path and doorbell equivalents):

    SUBMIT      SQE entered the submission path (device side)
    SQ_POP      a poller popped the SQE off the SQ (aux = poller thread)
    FUSE_MERGE  the call joined a genesys.fuse merged group (aux = group)
    DISPATCH    a worker started the call's bundle (aux = worker thread)
    COMPLETE    the call's retval exists (futures resolve right after)
    REAP        the call's CQE was drained by a consumer
    IRQ         doorbell-path submit: the device interrupt fired
    FALLBACK    ring SQ overflow routed the call onto the doorbell path
    THROTTLE    QoS admission delayed the submission (aux = delay µs)
    REJECT      QoS admission refused the submission (aux = call count)

Request-scoped events (the serving stack, genesys.metrics PR): a serving
request is a *span* keyed by its wire tag (seq = span id, sysno =
``REQ_SYSNO``):

    REQ_BEGIN   request parsed off the socket (aux = token budget)
    REQ_END     reply handed to the send path (aux = tokens generated)
    STEP        one engine decode dispatch, recorded once per step as a
                block over the active slots' span ids (aux = step
                duration ns, ts = step start)

While a thread holds :meth:`Tracer.span`, every ring SUBMIT it records
carries the span id in ``aux`` — so the Chrome exporter can nest the
request's own syscalls (the reply SENDTO, KV spill/revival I/O) inside
its request span on the pid-5 "request" track.

Named spans (the training loop's phases) pair two events on one channel,
joined on ``(channel, seq)`` like the stages above:

    SPAN_BEGIN  a span opened (sysno = its interned name, seq = the span
                id, aux = the enclosing span's id, 0 = none)
    SPAN_END    it closed (aux = its device ns where it had device marks)

:class:`SpanRecorder` records them. While one is open its id is the
thread's span context above (so a doorbell IRQ carries it too, as a ring
SUBMIT does), and code below the span's owner adds children through
:func:`current_recorder`. Ring stamps are ``perf_counter_ns``;
:attr:`Tracer.clock` pairs one with ``time.time_ns()``, the clock
``torch.profiler`` stamps its events in, and :meth:`Tracer.closed_spans`
and the Chrome export's ``metadata["clock"]`` map them to it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time
from collections import deque

import numpy as np


def _sys_names() -> dict:
    # deferred: syscalls.py itself uses trace.Counters, so importing it at
    # module load would be circular
    from repro_torch.core.genesys.syscalls import _SYS_NAMES
    return _SYS_NAMES

# -- lifecycle event codes (0 is reserved: "never written") -------------------
EV_SUBMIT = 1
EV_SQ_POP = 2
EV_FUSE_MERGE = 3
EV_DISPATCH = 4
EV_COMPLETE = 5
EV_REAP = 6
EV_IRQ = 7
EV_FALLBACK = 8
EV_THROTTLE = 9
EV_REJECT = 10
EV_REQ_BEGIN = 11
EV_REQ_END = 12
EV_STEP = 13
EV_SPAN_BEGIN = 14
EV_SPAN_END = 15

EV_NAMES = {
    EV_SUBMIT: "SUBMIT", EV_SQ_POP: "SQ_POP", EV_FUSE_MERGE: "FUSE_MERGE",
    EV_DISPATCH: "DISPATCH", EV_COMPLETE: "COMPLETE", EV_REAP: "REAP",
    EV_IRQ: "IRQ", EV_FALLBACK: "FALLBACK", EV_THROTTLE: "THROTTLE",
    EV_REJECT: "REJECT", EV_REQ_BEGIN: "REQ_BEGIN", EV_REQ_END: "REQ_END",
    EV_STEP: "STEP",
    EV_SPAN_BEGIN: "SPAN_BEGIN", EV_SPAN_END: "SPAN_END",
}

# the sysno request-span events carry (a request is not one syscall);
# latency_histograms names it "REQUEST" so the serving channel's
# end-to-end wall-time histogram reads like any syscall stage
REQ_SYSNO = -2

# a named span's sysno: its name interned process-wide (so one name reads
# the same in every tracer), above every syscall number
SPAN_SYSNO = 1 << 20
_span_names: list[str] = []
_span_ids: dict[str, int] = {}
_span_lock = threading.Lock()


def span_sysno(name: str) -> int:
    """The sysno that span events of ``name`` carry."""
    sysno = _span_ids.get(name)            # lock-free hit (GIL-safe read)
    if sysno is None:
        with _span_lock:
            sysno = _span_ids.get(name)
            if sysno is None:
                sysno = SPAN_SYSNO + len(_span_names)
                _span_names.append(name)
                _span_ids[name] = sysno
    return sysno


def span_name(sysno: int) -> str:
    return _span_names[sysno - SPAN_SYSNO]


def _clock_pair() -> tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` read together: the perf_counter
    reading of the tightest of a few time_ns brackets, beside their
    middle. Both clocks take NTP's slewing alike, so one pair maps every
    later stamp; a step of the wall clock would break it."""
    best = None
    for _ in range(5):
        w0 = time.time_ns()
        p = time.perf_counter_ns()
        w1 = time.time_ns()
        if best is None or w1 - w0 < best[0]:
            best = (w1 - w0, p, (w0 + w1) // 2)
    return best[1], best[2]

# Lifecycle stages as (name, from_event, to_event) pairs; the histogram
# matcher joins the two event sets on (channel, seq). Grouping metadata
# (tenant, sysno) is taken from the *from* side, so REAP (which records
# sysno = -1: the CQE carries only user_data) still attributes correctly.
STAGES = (
    ("queue", EV_SUBMIT, EV_SQ_POP),        # SQ residency until pop
    ("dispatch", EV_SQ_POP, EV_DISPATCH),   # pop -> worker pickup
    ("service", EV_DISPATCH, EV_COMPLETE),  # bundle execution
    ("total", EV_SUBMIT, EV_COMPLETE),      # submit -> retval exists
    ("reap", EV_COMPLETE, EV_REAP),         # retval -> CQE drained
    ("irq_total", EV_IRQ, EV_COMPLETE),     # doorbell end-to-end
    ("request", EV_REQ_BEGIN, EV_REQ_END),  # serving request wall time
    ("span", EV_SPAN_BEGIN, EV_SPAN_END),   # named span wall time
)

EVENT_DTYPE = np.dtype([
    ("ts", np.int64),        # perf_counter_ns timestamp
    ("ev", np.int16),        # lifecycle event code (0 = never written)
    ("tenant", np.int16),    # interned channel id
    ("sysno", np.int32),     # syscall number (-1 where unknowable: REAP)
    ("seq", np.int64),       # per-call key: ring user_data / tracer seq
    ("aux", np.int64),       # event-specific: thread id, group id, µs, ...
])

# (channel, seq) -> one int64 join key; seqs are ring user_data counters
# or tracer-allocated ids, both far below 2^44 in any real run
_KEY_BASE = np.int64(1) << np.int64(44)


def _col_part(v, n: int, dt) -> np.ndarray:
    """One staged block's contribution to a flushed column."""
    if isinstance(v, int):
        return np.full(n, v, dtype=dt)
    if isinstance(v, np.ndarray):
        return v.astype(dt, copy=False).reshape(-1)
    return np.asarray(v, dtype=dt).reshape(-1)     # list staged by ref


class Counters:
    """One lock + one mutable stats object: the shared discipline behind
    every genesys ``*Stats`` record (and the syscall table's dict).

    All read-modify-writes go through :meth:`add` / :meth:`bump` /
    :meth:`update` under :attr:`lock`; :meth:`snapshot` copies every
    field under the same lock, so snapshot reads are consistent with
    concurrent writers by construction — no field is ever observed
    mid-update, and cross-field sums cannot tear.
    """

    def __init__(self, stats):
        self.stats = stats
        self.lock = threading.Lock()

    def add(self, **deltas) -> None:
        """Increment attribute counters (ints or floats) atomically.
        Augmented-assignment semantics (``+=``): in-place ``__iadd__`` is
        honored when the field value defines it."""
        with self.lock:
            s = self.stats
            for k, v in deltas.items():
                cur = getattr(s, k)
                iadd = getattr(type(cur), "__iadd__", None)
                setattr(s, k, cur + v if iadd is None else iadd(cur, v))

    def bump(self, key, n: int = 1, hist: str | None = None) -> None:
        """Increment a dict-style counter: ``stats[key]`` when the stats
        object is itself a dict, else ``getattr(stats, hist)[key]``."""
        with self.lock:
            d = self.stats if hist is None else getattr(self.stats, hist)
            d[key] = d.get(key, 0) + n

    def update(self, fn) -> None:
        """Run an arbitrary multi-field mutation under the lock."""
        with self.lock:
            fn(self.stats)

    def snapshot(self) -> dict:
        """Consistent copy of every counter field, taken under the lock."""
        with self.lock:
            s = self.stats
            if isinstance(s, dict):
                return dict(s)
            out = {}
            for f in dataclasses.fields(s):
                v = getattr(s, f.name)
                out[f.name] = dict(v) if isinstance(v, dict) else v
            return out


class EventRing:
    """Fixed-capacity wraparound ring of lifecycle events.

    Appends are block-grain and two-phase: the hot path *stages* a
    bundle's events — one timestamp, the seq/sysno columns copied, one
    deque append under the lock (~no numpy per-field cost where the
    ring machinery itself is counting nanoseconds) — and the read path
    *materializes* staged blocks into the numpy ring with vectorized
    column writes (``np.repeat`` over block lengths + one concatenate
    per column). Staged blocks whose events are already guaranteed
    overwritten are dropped without ever being materialized, so memory
    stays bounded by ``capacity`` either way.

    Writes and flushes happen entirely under the lock and
    :meth:`snapshot` flushes + reads under the same lock, so a reader
    can never observe a torn entry. Once ``total`` exceeds
    ``capacity`` the oldest events are overwritten (``dropped`` counts
    them) and any analysis degrades to whatever pairs remain — plus
    the pure counters, which never drop.
    """

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = max(64, int(capacity))
        self.buf = np.zeros(self.capacity, dtype=EVENT_DTYPE)
        self._tail = 0           # monotonic append count (incl. staged)
        self._flushed = 0        # events materialized into buf
        # staged blocks: (ts, ev, tenant, sysno, seq, aux, n); sysno /
        # seq / aux are scalars, lists, or arrays (converted at flush)
        self._pending: deque = deque()
        self._staged = 0
        self._lock = threading.Lock()

    @property
    def total(self) -> int:
        return self._tail

    @property
    def dropped(self) -> int:
        return max(0, self._tail - self.capacity)

    def _stage(self, block, n: int) -> None:
        """Publish one staged block (lock held by caller)."""
        self._pending.append(block)
        self._staged += n
        self._tail += n
        # drop whole staged blocks that the newer staged events already
        # guarantee to overwrite (keeps staging memory <= ~capacity)
        pend = self._pending
        while self._staged - pend[0][6] >= self.capacity:
            self._staged -= pend.popleft()[6]

    def append_block(self, ev: int, tenant: int, sysnos, seqs, aux=0,
                     ts: int | None = None, own: bool = False) -> None:
        """Record ``len(seqs)`` events sharing one timestamp (bundle
        grain — exactly the granularity the ring machinery itself works
        at). ``sysnos``/``aux`` may be scalars or per-event columns.
        Columns may be lists or arrays; lists are always staged by
        reference and arrays too when ``own=True`` — either way the
        caller must not mutate them afterwards (every genesys site
        passes freshly built throwaway columns). Conversion to the
        numpy ring happens lazily on the read path."""
        if isinstance(seqs, np.ndarray):
            n = seqs.size
            seq_val = seqs if own else seqs.copy()
        elif isinstance(seqs, (int, np.integer)):
            n, seq_val = 1, int(seqs)
        else:
            n, seq_val = len(seqs), seqs
        if n == 0:
            return
        if ts is None:
            ts = time.perf_counter_ns()
        if isinstance(sysnos, (int, np.integer)):
            sysnos = int(sysnos)
        elif isinstance(sysnos, np.ndarray) and not own:
            sysnos = sysnos.copy()
        if isinstance(aux, (int, np.integer)):
            aux = int(aux)
        elif isinstance(aux, np.ndarray) and not own:
            aux = aux.copy()
        with self._lock:
            self._stage((ts, ev, tenant, sysnos, seq_val, aux, n), n)

    def append(self, ev: int, tenant: int, sysno: int, seq: int,
               aux: int = 0, ts: int | None = None) -> None:
        """Single-event convenience (doorbell path, QoS decisions)."""
        if ts is None:
            ts = time.perf_counter_ns()
        with self._lock:
            self._stage((ts, ev, tenant, int(sysno), int(seq), int(aux), 1),
                        1)

    def _flush_locked(self) -> None:
        """Materialize staged blocks into the ring (lock held)."""
        if not self._pending:
            return
        blocks = list(self._pending)
        self._pending.clear()
        self._staged = 0
        lens = np.array([b[6] for b in blocks], dtype=np.int64)
        total = int(lens.sum())

        def col(idx: int, dt) -> np.ndarray:
            vals = [b[idx] for b in blocks]
            if all(type(v) is int for v in vals):
                return np.repeat(np.asarray(vals, dtype=dt), lens)
            return np.concatenate(
                [_col_part(v, n, dt) for v, n in zip(vals, lens)])

        cols = {
            "ts": np.repeat(np.array([b[0] for b in blocks], np.int64), lens),
            "ev": np.repeat(np.array([b[1] for b in blocks], np.int16), lens),
            "tenant": np.repeat(
                np.array([b[2] for b in blocks], np.int16), lens),
            "sysno": col(3, np.int32),
            "seq": col(4, np.int64),
            "aux": col(5, np.int64),
        }
        cap = self.capacity
        if total > cap:                   # keep only the newest cap rows
            drop = total - cap
            cols = {k: v[drop:] for k, v in cols.items()}
            self._flushed += drop         # skipped rows still advance pos
            total = cap
        pos = self._flushed % cap
        first = min(total, cap - pos)
        buf = self.buf
        for lo, hi, sl in ((0, first, slice(pos, pos + first)),
                           (first, total, slice(0, total - first))):
            if lo < hi:
                for k, v in cols.items():
                    buf[k][sl] = v[lo:hi]
        self._flushed += total

    def snapshot(self) -> np.ndarray:
        """Copy of all live events in append order (oldest first)."""
        with self._lock:
            self._flush_locked()
            t, cap = self._flushed, self.capacity
            if t <= cap:
                return self.buf[:t].copy()
            pos = t % cap
            return np.concatenate([self.buf[pos:], self.buf[:pos]])


class TraceChannel:
    """A tracer binding for one event source (tenant ring, shared ring,
    doorbell executor): carries the interned channel id so hot-path
    records never touch a string."""

    __slots__ = ("tracer", "tid", "name")

    def __init__(self, tracer: "Tracer", tid: int, name: str):
        self.tracer = tracer
        self.tid = tid
        self.name = name

    def rec(self, ev: int, sysno: int, seq: int, aux: int = 0,
            ts: int | None = None) -> None:
        if ev == EV_IRQ and not aux:
            # a doorbell call carries its caller's span, as a ring SUBMIT
            aux = self.tracer.current_span()
        self.tracer.events.append(ev, self.tid, sysno, seq, aux, ts=ts)

    def rec_block(self, ev: int, sysnos, seqs, aux=0,
                  own: bool = False, ts: int | None = None) -> None:
        self.tracer.events.append_block(ev, self.tid, sysnos, seqs, aux,
                                        ts=ts, own=own)

    def next_seq(self) -> int:
        return self.tracer.next_seq()

    def thread_aux(self) -> int:
        return self.tracer.thread_id()

    def span_aux(self) -> int:
        """The calling thread's current request-span id (0 = none)."""
        return self.tracer.current_span()


class Tracer:
    """Owner of the event ring + channel/thread interning + exporters."""

    def __init__(self, capacity: int = 1 << 16):
        self.events = EventRing(capacity)
        self._lock = threading.Lock()
        self._channels: dict[str, TraceChannel] = {}
        self._channel_names: list[str] = []
        self._threads: dict[int, int] = {}       # thread ident -> small id
        self._thread_names: list[str] = []
        # doorbell-path calls have no user_data; they draw per-call keys
        # here (itertools.count: one atomic C-level next() per call)
        self._seq = itertools.count(1)
        # request-span context: per-thread current span id; SUBMIT records
        # stamp it into aux so a request's own syscalls nest under its span
        self._span = threading.local()
        # ring stamps -> time.time_ns(), the profiler's clock (wall_ns)
        self.clock = _clock_pair()

    # -- request-span context -------------------------------------------------
    def current_span(self) -> int:
        return getattr(self._span, "v", 0)

    def set_span(self, span_id: int) -> int:
        """Set the calling thread's span context; returns the previous
        value (0 = none) so callers can restore it."""
        prev = getattr(self._span, "v", 0)
        self._span.v = int(span_id)
        return prev

    @contextlib.contextmanager
    def span(self, span_id: int):
        """Scope a request-span id over the calling thread: ring SUBMITs
        recorded inside carry ``span_id`` in their aux column."""
        prev = self.set_span(span_id)
        try:
            yield
        finally:
            self._span.v = prev

    # -- named spans ----------------------------------------------------------
    def wall_ns(self, ts):
        """Ring stamps (``perf_counter_ns``; an int or an array) in
        ``time.time_ns()``'s clock, the one ``torch.profiler`` stamps
        its events in."""
        p, w = self.clock
        return ts - p + w

    def closed_spans(self, channel: str | None = None) -> list[dict]:
        """The named spans (of ``channel``, or all) whose SPAN_BEGIN and
        SPAN_END are both in the ring, oldest first: ``name``, ``id``,
        ``parent`` (0 = none), ``index`` (how many spans of that name
        the parent opened before it: a microbatch's), ``start_ns`` and
        ``end_ns`` in ``time.time_ns()``'s clock, ``device_ns`` (0
        without device marks) and ``channel``. A span whose SPAN_BEGIN the
        ring has overwritten is left out, never returned torn."""
        names = self.channel_names()
        if channel is not None and channel not in names:
            return []
        A, B, ia, ib = _match_events(self.events.snapshot(), EV_SPAN_BEGIN,
                                     EV_SPAN_END)
        if channel is not None:
            keep = A["tenant"][ia] == names.index(channel)
            ia, ib = ia[keep], ib[keep]
        order = np.argsort(A["ts"][ia], kind="stable")
        a, b = A[ia[order]], B[ib[order]]
        start, end = self.wall_ns(a["ts"]), self.wall_ns(b["ts"])
        out, seen = [], {}
        for j in range(len(a)):
            name, parent = span_name(int(a["sysno"][j])), int(a["aux"][j])
            index = seen.get((parent, name), 0)
            seen[(parent, name)] = index + 1
            out.append({"name": name, "id": int(a["seq"][j]),
                        "parent": parent, "index": index,
                        "start_ns": int(start[j]), "end_ns": int(end[j]),
                        "device_ns": int(b["aux"][j]),
                        "channel": names[int(a["tenant"][j])]})
        return out

    # -- interning ------------------------------------------------------------
    def channel(self, name: str) -> TraceChannel:
        with self._lock:
            ch = self._channels.get(name)
            if ch is None:
                ch = TraceChannel(self, len(self._channel_names), name)
                self._channel_names.append(name)
                self._channels[name] = ch
            return ch

    def channel_names(self) -> list[str]:
        with self._lock:
            return list(self._channel_names)

    def next_seq(self) -> int:
        return next(self._seq)

    def thread_id(self) -> int:
        ident = threading.get_ident()
        tid = self._threads.get(ident)      # lock-free hit (GIL-safe read)
        if tid is None:
            with self._lock:
                tid = self._threads.get(ident)
                if tid is None:
                    tid = len(self._thread_names)
                    self._thread_names.append(threading.current_thread().name)
                    self._threads[ident] = tid
        return tid

    def thread_names(self) -> list[str]:
        with self._lock:
            return list(self._thread_names)

    # -- analysis -------------------------------------------------------------
    def histograms(self) -> dict:
        return latency_histograms(self.events.snapshot(),
                                  self.channel_names())

    def meta(self) -> dict:
        return {
            "enabled": True,
            "capacity": self.events.capacity,
            "events": self.events.total,
            "dropped": self.events.dropped,
            "wrapped": self.events.dropped > 0,
            "channels": self.channel_names(),
            "clock": {"perf_counter_ns": self.clock[0],
                      "time_ns": self.clock[1]},
        }

    # -- Chrome-trace / Perfetto export ---------------------------------------
    def export_chrome_trace(self, path: str, *, max_spans: int = 100_000
                            ) -> dict:
        """Write a Chrome-trace JSON (load in Perfetto / chrome://tracing).

        Tracks: pid 1 "ring" (SQ residency per channel), pid 2 "poller"
        (pop -> worker handoff per poller thread), pid 3 "worker"
        (bundle execution per worker thread, with fused groups as
        attributed spans), pid 4 "tenant" (per-call submit -> complete
        spans per channel, REAP instants), pid 5 "request" (one track
        per serving request span id: the request's wall-time span, its
        engine decode-step spans, and every span-attributed syscall
        nested inside). Spans beyond ``max_spans`` are counted, not
        silently elided: ``trace["metadata"]["dropped_spans"]`` reports
        the loss. Returns the trace dict."""
        evs = self.events.snapshot()
        ch_names = self.channel_names()
        th_names = self.thread_names()
        out: list[dict] = []
        dropped = 0

        def put(rec: dict) -> None:
            nonlocal dropped
            if len(out) >= max_spans:
                dropped += 1
            else:
                out.append(rec)

        for pid, pname in ((1, "ring"), (2, "poller"), (3, "worker"),
                           (4, "tenant"), (5, "request")):
            out.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name", "args": {"name": pname}})
        for pid in (1, 4):
            for tid, name in enumerate(ch_names):
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name", "args": {"name": name}})
        for pid in (2, 3):
            for tid, name in enumerate(th_names):
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name", "args": {"name": name}})
        if len(evs):
            t0 = int(evs["ts"].min())

            def us(ts) -> float:
                return (int(ts) - t0) / 1e3

            def spans(ea, eb, pid, tid_from, namer, args=None):
                A, B, ia, ib = _match_events(evs, ea, eb)
                for j in range(len(ia)):
                    a, b = A[ia[j]], B[ib[j]]
                    rec = {"ph": "X", "pid": pid,
                           "tid": int(a["aux"] if tid_from == "aux"
                                      else (a["seq"] if tid_from == "seq"
                                            else a["tenant"])),
                           "ts": us(a["ts"]),
                           "dur": max(0.0, us(b["ts"]) - us(a["ts"])),
                           "name": namer(a)}
                    if args is not None:
                        rec["args"] = args(a, b)
                    put(rec)

            names = _sys_names()

            def sysname(a) -> str:
                return names.get(int(a["sysno"]), str(int(a["sysno"])))

            spans(EV_SUBMIT, EV_SQ_POP, 1, "tenant",
                  lambda a: f"sq:{sysname(a)}")
            spans(EV_SQ_POP, EV_DISPATCH, 2, "aux",
                  lambda a: f"reap:{sysname(a)}")
            spans(EV_DISPATCH, EV_COMPLETE, 3, "aux", sysname,
                  args=lambda a, b: {"seq": int(a["seq"])})
            spans(EV_SUBMIT, EV_COMPLETE, 4, "tenant", sysname,
                  args=lambda a, b: {"seq": int(a["seq"])})
            spans(EV_IRQ, EV_COMPLETE, 4, "tenant",
                  lambda a: f"irq:{sysname(a)}",
                  args=lambda a, b: {"seq": int(a["seq"])})
            # pid 5 "request": one track per serving request span id.
            # The request wall-time span, then its decode steps, then the
            # syscalls whose SUBMIT was recorded under Tracer.span() —
            # same tid, so Chrome/Perfetto nest them by time containment.
            spans(EV_REQ_BEGIN, EV_REQ_END, 5, "seq",
                  lambda a: "request",
                  args=lambda a, b: {"span": int(a["seq"]),
                                     "budget": int(a["aux"]),
                                     "tokens": int(b["aux"])})
            for r in evs[evs["ev"] == EV_STEP]:
                put({"ph": "X", "pid": 5, "tid": int(r["seq"]),
                     "ts": us(r["ts"]), "dur": max(0.0, int(r["aux"]) / 1e3),
                     "name": f"step:{int(r['sysno'])}"})
            # pid 6 "training": named spans, a track a channel, nested by
            # time; the syscalls a thread made inside one (ring SUBMITs,
            # doorbell IRQs) on its span's track
            begins = evs[evs["ev"] == EV_SPAN_BEGIN]
            named = dict(zip(begins["seq"].tolist(),
                             begins["tenant"].tolist()))
            if named:
                out.append({"ph": "M", "pid": 6, "tid": 0,
                            "name": "process_name",
                            "args": {"name": "training"}})
                for tid in sorted(set(named.values())):
                    out.append({"ph": "M", "pid": 6, "tid": tid,
                                "name": "thread_name",
                                "args": {"name": ch_names[tid]}})
                spans(EV_SPAN_BEGIN, EV_SPAN_END, 6, "tenant",
                      lambda a: span_name(int(a["sysno"])),
                      args=lambda a, b: {"span": int(a["seq"]),
                                         "parent": int(a["aux"]),
                                         "device_ms": int(b["aux"]) / 1e6})
                for ea in (EV_SUBMIT, EV_IRQ):
                    A, B, ia, ib = _match_events(evs, ea, EV_COMPLETE)
                    for j in range(len(ia)):
                        a, b = A[ia[j]], B[ib[j]]
                        if int(a["aux"]) not in named:
                            continue
                        put({"ph": "X", "pid": 6,
                             "tid": named[int(a["aux"])], "ts": us(a["ts"]),
                             "dur": max(0.0, us(b["ts"]) - us(a["ts"])),
                             "name": f"sys:{sysname(a)}",
                             "args": {"seq": int(a["seq"]),
                                      "span": int(a["aux"])}})
            A, B, ia, ib = _match_events(evs, EV_SUBMIT, EV_COMPLETE)
            for j in range(len(ia)):
                a, b = A[ia[j]], B[ib[j]]
                if int(a["aux"]) == 0:
                    continue            # not recorded under a span context
                if int(a["aux"]) in named:
                    continue            # on the training track (pid 6)
                put({"ph": "X", "pid": 5, "tid": int(a["aux"]),
                     "ts": us(a["ts"]),
                     "dur": max(0.0, us(b["ts"]) - us(a["ts"])),
                     "name": f"sys:{sysname(a)}",
                     "args": {"seq": int(a["seq"])}})
            for seq in np.unique(
                    evs[evs["ev"] == EV_REQ_BEGIN]["seq"])[:256]:
                out.append({"ph": "M", "pid": 5, "tid": int(seq),
                            "name": "thread_name",
                            "args": {"name": f"req:{int(seq)}"}})
            # fused bundles: one span per merge group, nested inside the
            # worker bundle span, members attributed by user_data
            merges = evs[evs["ev"] == EV_FUSE_MERGE]
            if len(merges):
                disp = evs[evs["ev"] == EV_DISPATCH]
                comp = evs[evs["ev"] == EV_COMPLETE]
                dmap = dict(zip((disp["tenant"].astype(np.int64) * _KEY_BASE
                                 + disp["seq"]).tolist(),
                                zip(disp["ts"].tolist(),
                                    disp["aux"].tolist())))
                cmap = dict(zip((comp["tenant"].astype(np.int64) * _KEY_BASE
                                 + comp["seq"]).tolist(),
                                comp["ts"].tolist()))
                for gid in np.unique(merges["aux"]):
                    grp = merges[merges["aux"] == gid]
                    keys = (grp["tenant"].astype(np.int64) * _KEY_BASE
                            + grp["seq"]).tolist()
                    ds = [dmap[k] for k in keys if k in dmap]
                    cs = [cmap[k] for k in keys if k in cmap]
                    if not ds or not cs:
                        continue
                    ts_lo = min(d[0] for d in ds)
                    put({
                        "ph": "X", "pid": 3, "tid": int(ds[0][1]),
                        "ts": us(ts_lo),
                        "dur": max(0.0, us(max(cs)) - us(ts_lo)),
                        "name": f"fuse:{sysname(grp[0])}[{len(grp)}]",
                        "args": {"group": int(gid),
                                 "members": grp["seq"].tolist()},
                    })
            for r in evs[evs["ev"] == EV_REAP]:
                put({"ph": "i", "pid": 4, "tid": int(r["tenant"]),
                     "ts": us(r["ts"]), "name": "reap", "s": "t"})
        trace = {"traceEvents": out, "displayTimeUnit": "ms",
                 "metadata": {"dropped_spans": dropped,
                              "max_spans": max_spans}}
        if len(evs):
            # ts is µs from the ring's first stamp: at this time_ns
            trace["metadata"]["clock"] = {
                "ts0_time_ns": int(self.wall_ns(int(evs["ts"].min()))),
                "perf_counter_ns": self.clock[0], "time_ns": self.clock[1]}
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


_current = threading.local()


def current_recorder() -> "SpanRecorder | None":
    """The recorder whose span the calling thread holds open, or None."""
    return getattr(_current, "rec", None)


class SpanRecorder:
    """Named, nested spans of a thread's work on one channel of a
    :class:`Tracer`: a SPAN_BEGIN (sysno = :func:`span_sysno` of the
    name, seq = a tracer-allocated id, aux = the enclosing span's id) and
    a SPAN_END (aux = device ns). While a span is open its id is the
    tracer's span context and this recorder is :func:`current_recorder`.

    ``marks`` (an object with ``begin()``, ``end()`` and
    ``elapsed_ns()``, such as a pair of CUDA events) time a span on a
    device. Its SPAN_END, stamped when the span closes, is held until
    :meth:`settle`, which the owner calls once the device has done the
    work (after a sync it makes anyway): recording adds no sync."""

    def __init__(self, tracer: Tracer, channel: str):
        self.tracer = tracer
        self.channel = tracer.channel(channel)
        self._held: list = []      # (sysno, id, end stamp, marks)
        self._open: list = []      # ids of the open spans, innermost last

    @contextlib.contextmanager
    def span(self, name: str, marks=None):
        tracer, ch = self.tracer, self.channel
        sysno, sid = span_sysno(name), tracer.next_seq()
        parent = tracer.set_span(sid)
        outer = current_recorder()
        _current.rec = self
        ch.rec(EV_SPAN_BEGIN, sysno, sid, parent)
        self._open.append(sid)
        if marks is not None:
            marks.begin()
        try:
            yield sid
        finally:
            if marks is not None:
                marks.end()
            ts = time.perf_counter_ns()
            self._open.remove(sid)
            tracer.set_span(parent)
            _current.rec = outer
            if marks is None:
                ch.rec(EV_SPAN_END, sysno, sid, 0, ts=ts)
            else:
                self._held.append((sysno, sid, ts, marks))

    @contextlib.contextmanager
    def adopted(self):
        """The calling thread holds this recorder's innermost open span for
        the block, so that the spans it opens nest there: for work that
        the owner's open span waits on but another thread runs, as
        autograd's backward runs a layer's recomputation. On the owner's
        own thread it changes nothing."""
        if current_recorder() is self or not self._open:
            yield
            return
        outer, parent = current_recorder(), self.tracer.set_span(
            self._open[-1])
        _current.rec = self
        try:
            yield
        finally:
            self.tracer.set_span(parent)
            _current.rec = outer

    def settle(self) -> None:
        """Record the held SPAN_ENDs with their marks' device ns."""
        held, self._held = self._held, []
        for sysno, sid, ts, marks in held:
            self.channel.rec(EV_SPAN_END, sysno, sid, marks.elapsed_ns(),
                             ts=ts)

    def closed(self) -> list[dict]:
        """This channel's closed spans (:meth:`Tracer.closed_spans`)."""
        return self.tracer.closed_spans(self.channel.name)


def _match_events(evs: np.ndarray, ea: int, eb: int):
    """Join the ``ea`` and ``eb`` event sets on (channel, seq). Returns
    ``(A, B, ia, ib)`` with ``A[ia[j]]`` paired to ``B[ib[j]]``."""
    A = evs[evs["ev"] == ea]
    B = evs[evs["ev"] == eb]
    if not len(A) or not len(B):
        return A, B, np.empty(0, np.int64), np.empty(0, np.int64)
    ka = A["tenant"].astype(np.int64) * _KEY_BASE + A["seq"]
    kb = B["tenant"].astype(np.int64) * _KEY_BASE + B["seq"]
    _, ia, ib = np.intersect1d(ka, kb, return_indices=True)
    return A, B, ia, ib


def bucket_of(us: float) -> int:
    """Log2 bucket index of a µs latency: bucket ``b`` covers
    ``(2^(b-1), 2^b]`` µs, bucket 0 is everything <= 1µs."""
    if us <= 1.0:
        return 0
    return int(np.ceil(np.log2(us)))


def latency_histograms(evs: np.ndarray, channel_names: list[str],
                       stages=STAGES) -> dict:
    """Per-(tenant, sysno, stage) log2-bucket latency histograms.

    Returns ``{channel: {SYSNAME: {stage: {count, p50_us, p99_us,
    max_us, buckets}}}}`` where ``buckets`` maps bucket exponent ``b``
    (upper edge ``2^b`` µs) to count, and p50/p99 are bucket upper
    edges (resolution: one power of two — the price of needing no
    per-call state). Everything is numpy: one intersect per stage, one
    bincount per group.
    """
    out: dict = {}
    names = _sys_names()
    for stage, ea, eb in stages:
        A, B, ia, ib = _match_events(evs, ea, eb)
        if not len(ia):
            continue
        dt_us = np.maximum((B["ts"][ib] - A["ts"][ia]) / 1e3, 0.0)
        tids = A["tenant"][ia].astype(np.int64)
        syss = A["sysno"][ia].astype(np.int64)
        gk = tids * (np.int64(1) << np.int64(32)) + (syss & 0xFFFFFFFF)
        buckets = np.where(dt_us <= 1.0, 0,
                           np.ceil(np.log2(np.maximum(dt_us, 1.0)))
                           ).astype(np.int64)
        for g in np.unique(gk):
            m = gk == g
            d = dt_us[m]
            counts = np.bincount(buckets[m])
            cum = counts.cumsum()
            n = int(cum[-1])
            p50_b = int(np.searchsorted(cum, 0.5 * n))
            p99_b = int(np.searchsorted(cum, 0.99 * n))
            tid = int(g >> np.int64(32))
            sysno = int(np.int32(g & 0xFFFFFFFF))
            cname = (channel_names[tid] if tid < len(channel_names)
                     else str(tid))
            sname = names.get(
                sysno, "REQUEST" if sysno == REQ_SYSNO else str(sysno))
            if sysno >= SPAN_SYSNO:
                sname = span_name(sysno)
            out.setdefault(cname, {}).setdefault(sname, {})[stage] = {
                "count": n,
                "p50_us": float(2.0 ** p50_b),
                "p99_us": float(2.0 ** p99_b),
                "max_us": float(d.max()),
                "buckets": {int(b): int(c)
                            for b, c in enumerate(counts) if c},
            }
    return out


# -- snapshot utilities --------------------------------------------------------

def jsonable(obj, *, drop: tuple = ()):
    """Recursively convert a telemetry snapshot to JSON-encodable types:
    numpy scalars -> Python, dict keys -> str, ``drop``ped keys elided."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v, drop=drop) for k, v in obj.items()
                if k not in drop}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v, drop=drop) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def _tenant_p99s(snap: dict) -> dict[str, float]:
    """Per-tenant end-to-end p99 (µs) from a telemetry snapshot — the
    input signal the ROADMAP's SLO-admission item consumes."""
    out: dict[str, float] = {}
    for cname, per_sys in (snap.get("histograms") or {}).items():
        worst = 0.0
        for stages in per_sys.values():
            st = (stages.get("total") or stages.get("irq_total")
                  or stages.get("request"))
            if st:
                worst = max(worst, st["p99_us"])
        if worst:
            out[cname] = worst
    return out


def summary_dict(snap: dict) -> dict:
    """Compact, JSON-safe digest of a telemetry snapshot (the serving
    STATS reply): top-level counters, per-tenant p99s, fuse ratio."""
    ex = snap.get("executor") or {}
    ring = snap.get("ring") or {}
    fuse = snap.get("fuse") or {}
    calls_in = fuse.get("calls_in", 0)
    tenants = {name: {"submitted": t["stats"].get("submitted", 0),
                      "reaped": t["stats"].get("reaped", 0),
                      "rejected": t["stats"].get("rejected", 0)}
               for name, t in (snap.get("tenants") or {}).items()}
    return jsonable({
        "submitted": snap.get("totals", {}).get("submitted", 0),
        "completed": snap.get("totals", {}).get("completed", 0),
        "reaped": snap.get("totals", {}).get("reaped", 0),
        "interrupts": ex.get("interrupts", 0),
        "ring_fallbacks": ring.get("fallback_doorbell", 0),
        "fuse_ratio": (fuse.get("fused_calls", 0) / calls_in
                       if calls_in else 0.0),
        "tenants": tenants,
        "p99_us": _tenant_p99s(snap),
        "trace": {k: (snap.get("trace") or {}).get(k)
                  for k in ("enabled", "events", "dropped")},
    })


def format_summary(snap: dict, prev: dict | None = None,
                   dt_s: float | None = None) -> str:
    """One-line human summary (the ``--stats-interval`` line):
    throughput, per-tenant p99, fuse ratio."""
    s = summary_dict(snap)
    done = s["completed"]
    if prev is not None and dt_s:
        rate = (done - summary_dict(prev)["completed"]) / dt_s
    elif dt_s:
        rate = done / dt_s
    else:
        rate = None
    parts = [f"telemetry: submitted={s['submitted']} completed={done} "
             f"reaped={s['reaped']}"]
    if rate is not None:
        parts.append(f"rate={rate:.0f}/s")
    parts.append(f"fuse={100.0 * s['fuse_ratio']:.0f}%")
    if s["p99_us"]:
        p99 = " ".join(f"{k}={v:.0f}" for k, v in sorted(s["p99_us"].items()))
        parts.append(f"p99_us[{p99}]")
    return " ".join(parts)

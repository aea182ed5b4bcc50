"""The GENESYS invocation façade: granularity x ordering x blocking.

Paper §4.1's design space, mapped to PyTorch on a CUDA card:

  granularity   WORK_ITEM   one slot per row of a batched request
                WORK_GROUP  one slot per call of a work-group
                KERNEL      one slot per call of a kernel

  ordering      STRONG            pre- AND post-dependency (barriers both sides)
                RELAXED_PRODUCER  pre-dependency only (write/send-like calls)
                RELAXED_CONSUMER  post-dependency only (read/recv-like calls)

  blocking      True   retval returned as a tensor
                False  fire-and-forget; Genesys.drain() is the §8.3 barrier

Constraints enforced before anything runs (paper §4.1):
  * WORK_ITEM supports only (implicit) STRONG ordering;
  * KERNEL granularity forbids STRONG ordering — on the GPU it deadlocks the
    hardware (not all work-items fit on the machine).

Syscall args travel as (lo, hi) int32 pairs: shape [6, 2] (or [n, 6, 2]
for WORK_ITEM batches), as in the JAX package, whose ``invoke`` reaches the
host through a host callback inside the jitted step. Here args on the CPU
take that same host entry (``Genesys._host_entry``); args on a CUDA card
take the device entry (``core/genesys/device.py``): a hand-written kernel
(``kernels/csrc/genesys_invoke.cu``) posts the slots into mapped host
memory, one thread a row, and a host thread rings the executor. On the
card a stream carries the barriers: STRONG and RELAXED_PRODUCER calls
launch on the caller's current stream, after all earlier work;
RELAXED_CONSUMER calls launch on a side stream that does not wait for it,
and a blocking one makes the caller's stream wait for the call.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.genesys.area import FLAG_BLOCKING, SyscallArea, Ticket
from repro_torch.core.genesys.completion import Completion
from repro_torch.core.genesys.executor import Executor
from repro_torch.core.genesys.heap import HostHeap
from repro_torch.core.genesys.memory_pool import MemoryPool
from repro_torch.core.genesys.sched import PolicyEngine, PollerGroup
from repro_torch.core.genesys.syscalls import SyscallTable, make_default_table
from repro_torch.core.genesys.tenant import Tenant
from repro_torch.core.genesys.trace import Tracer
from repro_torch.core.genesys.uring import SyscallRing


class Granularity(Enum):
    WORK_ITEM = "work_item"
    WORK_GROUP = "work_group"
    KERNEL = "kernel"


class Ordering(Enum):
    STRONG = "strong"
    RELAXED_PRODUCER = "relaxed_producer"
    RELAXED_CONSUMER = "relaxed_consumer"


@dataclass(frozen=True)
class GenesysConfig:
    n_slots: int = 4096
    n_workers: int = 2
    coalesce_window_us: int = 0   # paper sysfs knob 1
    coalesce_max: int = 1         # paper sysfs knob 2
    # genesys.uring: submission/completion ring knobs (lazy; the poller
    # thread only starts on first ring use)
    ring_sq_depth: int = 256
    ring_cq_depth: int = 1024
    ring_batch_max: int = 64      # SQEs per executor bundle
    ring_spin_polls: int = 64     # busy polls before the poller parks
    ring_max_sleep_s: float = 0.002
    # genesys.sched: per-tenant ring + multi-poller reaper knobs (lazy; the
    # PollerGroup only starts when the first tenant is created)
    sched_pollers: int = 1        # poller threads reaping tenant SQs
    sched_inline: bool = False    # SQPOLL mode: pollers dispatch bundles
    tenant_slots: int = 256       # area partition carved per tenant
    tenant_sq_depth: int = 128
    tenant_cq_depth: int = 512
    # genesys.fuse: cross-call coalescing of popped ring bundles
    ring_fuse: bool = False       # fuse the shared ring's bundles
    fuse_max_span: int = 8 << 20  # merged-read byte-span bound
    # genesys.trace: lifecycle telemetry (off by default; when the event
    # ring wraps, histograms degrade gracefully — counters never drop)
    trace: bool = False
    trace_capacity: int = 1 << 16  # event-ring entries (32 B each)
    # genesys.metrics: windowed time-series history kept by the lazy
    # Genesys.metrics registry (one snapshot per tick)
    metrics_windows: int = 120
    # genesys.arena: the zero-copy data plane. True (default) backs the
    # heap with a HostArena — new_buffer/register_bytes hand out extents
    # of registered uint8 segments, syscall completions land in place.
    # False keeps the legacy dict-of-objects HostHeap (the benchmark
    # baseline in benchmarks/fig15_zerocopy.py).
    arena: bool = True
    arena_segment_bytes: int = 1 << 20


# ---------- int64 <-> (lo, hi) int32 packing ---------------------------------

def _split64(v: int) -> tuple[int, int]:
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    lo = v & 0xFFFFFFFF
    hi = (v >> 32) & 0xFFFFFFFF
    # store as signed int32 bit patterns
    return (lo - (1 << 32) if lo >= (1 << 31) else lo,
            hi - (1 << 32) if hi >= (1 << 31) else hi)


def _join64(lo, hi) -> int:
    return ((int(hi) & 0xFFFFFFFF) << 32) | (int(lo) & 0xFFFFFFFF)


# set on a pack_args result whose values were copied to the card
# synchronously: a call with no pre-dependency need not wait for them
_ARGS_READY = "_genesys_args_ready"


def pack_args(*vals, device="cuda") -> torch.Tensor:
    """Pack up to 6 syscall args into a [6, 2] int32 tensor on ``device``.
    Python ints split into (lo, hi); a 0-d tensor packs into the lo word,
    as a traced scalar does in the JAX package."""
    if len(vals) > 6:
        raise ValueError(f"a syscall takes at most 6 args, got {len(vals)}")
    words = np.zeros((6, 2), dtype=np.int32)
    scalars = []
    for i, v in enumerate(vals):
        if isinstance(v, (int, np.integer)):
            words[i] = _split64(int(v))
        else:
            scalars.append((i, v))
    out = torch.from_numpy(words).to(device)
    for i, v in scalars:
        out[i, 0] = torch.as_tensor(v).to(out.device, torch.int32)
    if not scalars and out.device.type == "cuda":
        setattr(out, _ARGS_READY, True)
    return out


def _np_join_batch(rows: np.ndarray) -> np.ndarray:
    """Vectorized arg-join: ``[k, 6, 2]`` int32 (lo, hi) pairs ->
    ``[k, 6]`` uint64 in two numpy ops — no per-call, per-arg Python
    loop on the WORK_ITEM hot path."""
    r = np.asarray(rows)
    m32 = np.uint64(0xFFFFFFFF)
    lo = r[..., 0].astype(np.uint64) & m32
    hi = r[..., 1].astype(np.uint64) & m32
    return (hi << np.uint64(32)) | lo


# ---------- data-dependency "barriers" ----------------------------------------

def _fold(tree) -> torch.Tensor:
    """Reduce a pytree of tensors to a zero-valued f32 scalar that still
    depends on every leaf (the pre-barrier)."""
    leaves = [l for l in pytree.tree_leaves(tree)
              if isinstance(l, torch.Tensor) or hasattr(l, "dtype")]
    z = None
    for l in leaves:
        lf = torch.as_tensor(l)
        term = lf.reshape(-1)[0].to(torch.float32) * 0.0
        z = term if z is None else z + term.to(z.device)
    return torch.zeros((), dtype=torch.float32) if z is None else z


def _tie(tree, tag: torch.Tensor):
    """Return `tree` with every leaf made dependent on `tag` (==0)."""
    def one(l):
        lf = torch.as_tensor(l)
        return lf + tag.to(lf.device, lf.dtype)
    return pytree.tree_map(one, tree)


@dataclass
class InvokeResult:
    """Outcome of a GENESYS invocation, on the args' device."""
    retval: torch.Tensor | None   # int32 [2] (lo,hi) or [n,2]; None if non-blocking
    _tag: torch.Tensor | None

    def ret64(self) -> torch.Tensor | None:
        """Return value as (lo) int32 — sufficient for sizes/fds/errnos."""
        if self.retval is None:
            return None
        return self.retval[..., 0]

    def tie(self, tree):
        """Make `tree` depend on syscall completion (the post-barrier).
        Identity for relaxed-producer / non-blocking invocations."""
        if self._tag is None:
            return tree
        return _tie(tree, self._tag)


class Genesys:
    """Owner of the syscall area, executor, heap and memory pool."""

    def __init__(self, config: GenesysConfig = GenesysConfig()):
        self.config = config
        if config.arena:
            from repro_torch.core.genesys.arena import HostArena
            self.heap = HostArena(segment_bytes=config.arena_segment_bytes)
        else:
            self.heap = HostHeap()
        self.pool = MemoryPool()
        self.table: SyscallTable = make_default_table(self.heap, self.pool)
        # register_bytes copy-ins count toward the table's bytes-copied
        # metrics (per-path: register/reply/...)
        self.heap.on_copy = self.table.note_copy
        self.area = SyscallArea(config.n_slots)
        self.executor = Executor(
            self.area, self.table,
            n_workers=config.n_workers,
            coalesce_window_us=config.coalesce_window_us,
            coalesce_max=config.coalesce_max,
        )
        self._lock = threading.Lock()
        self._ring: SyscallRing | None = None
        # genesys.sched: tenant registry + shared policy engine + pollers
        self.engine = PolicyEngine()
        self._tenants: dict[str, Tenant] = {}
        self._sched: PollerGroup | None = None
        # genesys.trace: one tracer shared by every channel (doorbell
        # executor, shared ring, tenant rings); None = tracing off
        self._tracer: Tracer | None = None
        # genesys.metrics: serving-stats registry (attach_stats) + lazy
        # time-series registry (the metrics property)
        self._ext_stats: dict[str, object] = {}
        self._metrics = None
        # the device entry's slot area and poller (created on the first
        # invocation with args on a card; see device.py)
        self._device = None
        if config.trace:
            self._tracer_locked()

    @property
    def ring(self) -> SyscallRing:
        """The genesys.uring submission/completion ring (created on first
        use; shares the slot area, worker pool, and drain() barrier)."""
        with self._lock:
            if self._ring is None:
                c = self.config
                fuse = None
                if c.ring_fuse:
                    from repro_torch.core.genesys.fuse import Coalescer
                    fuse = Coalescer(max_span=c.fuse_max_span)
                self._ring = SyscallRing(
                    self.area, self.executor,
                    sq_depth=c.ring_sq_depth, cq_depth=c.ring_cq_depth,
                    batch_max=c.ring_batch_max, spin_polls=c.ring_spin_polls,
                    max_sleep_s=c.ring_max_sleep_s, fuse=fuse)
                if self._tracer is not None:
                    self._ring.trace = self._tracer.channel("ring")
            return self._ring

    # ------------- host-side path (used by substrates & the executor itself) --
    def call(self, sysno: int, *args, blocking: bool = True,
             hw_id: int = 0) -> int | Ticket:
        t = self.area.acquire(hw_id)
        self.area.post(t, int(sysno), [int(a) for a in args], blocking)
        self.executor.interrupt(t.slot)
        if blocking:
            return self.area.wait(t)
        return t

    def call_async(self, sysno: int, *args, hw_id: int = 0) -> Ticket:
        """Post a *blocking-slot* syscall but defer the wait: the paper's
        'weak ordering + blocking' combination — some waiter eventually
        polls the FINISHED slot (e.g. the data-prefetch pipeline)."""
        t = self.area.acquire(hw_id)
        self.area.post(t, int(sysno), [int(a) for a in args], True)
        self.executor.interrupt(t.slot)
        return t

    def wait(self, ticket: Ticket, timeout: float | None = None) -> int:
        return self.area.wait(ticket, timeout=timeout)

    def drain(self) -> None:
        device = self._device
        if device is not None:
            # calls the card has posted, or will post once its stream gets
            # there, reach the executor first
            device.drain()
        self.executor.drain()

    def shutdown(self) -> None:
        with self._lock:
            ring, self._ring = self._ring, None
            tenants, self._tenants = dict(self._tenants), {}
            sched, self._sched = self._sched, None
            device, self._device = self._device, None
        try:
            if device is not None:
                device.close()
        finally:
            self._shutdown_host(ring, tenants, sched)

    def _shutdown_host(self, ring, tenants, sched) -> None:
        if sched is not None:
            sched.stop()
        for t in tenants.values():
            # flush SQEs the stopped pollers never saw, so drain() (inside
            # executor.shutdown) cannot hang on unpopped tenant entries
            while t.ring.process_pending():
                pass
        if ring is not None:
            ring.close()
        self.executor.shutdown()

    # ------------- genesys.sched: tenants, policies, pollers --------------------
    @property
    def sched(self) -> PollerGroup:
        """The shared multi-poller reaper over all tenant rings (created on
        first tenant; ``sched_pollers``/``sched_inline`` config knobs)."""
        with self._lock:
            return self._sched_locked()

    def _sched_locked(self) -> PollerGroup:
        if self._sched is None:
            c = self.config
            self._sched = PollerGroup(
                n_pollers=c.sched_pollers, engine=self.engine,
                inline=c.sched_inline, spin_polls=c.ring_spin_polls,
                max_sleep_s=c.ring_max_sleep_s)
            self._sched.start()
        return self._sched

    # ------------- genesys.trace: telemetry ------------------------------------
    def _tracer_locked(self) -> Tracer:
        """Create the shared tracer on first demand and wire the executor's
        doorbell channel (callers hold ``self._lock`` or are ``__init__``)."""
        if self._tracer is None:
            self._tracer = Tracer(self.config.trace_capacity)
            self.executor.trace = self._tracer.channel("doorbell")
        return self._tracer

    @property
    def tracer(self) -> Tracer | None:
        """The shared lifecycle tracer, or ``None`` when tracing is off."""
        return self._tracer

    # ------------- genesys.metrics: time-series registry -------------------
    @property
    def metrics(self):
        """The lazy :class:`~repro_torch.core.genesys.metrics.MetricsRegistry`
        for this instance; first access creates it and installs the
        telemetry-mirroring collector, so every tick (scrape) carries the
        full genesys counter/histogram state with zero extra wiring."""
        with self._lock:
            if self._metrics is None:
                from repro_torch.core.genesys.metrics import (
                    MetricsRegistry, install_genesys_collector)
                self._metrics = MetricsRegistry(
                    n_windows=self.config.metrics_windows)
                install_genesys_collector(self._metrics, self)
            return self._metrics

    def attach_stats(self, name: str, counters) -> None:
        """Register an external (serving-side) ``trace.Counters`` record
        under ``name``; its snapshot joins ``telemetry()["serving"]`` —
        the one-coherent-snapshot contract extended beyond core genesys."""
        with self._lock:
            self._ext_stats[name] = counters

    def telemetry(self) -> dict:
        """One coherent observability snapshot: every subsystem's counters
        (executor, shared ring + fuse, scheduler, syscall table, tenants)
        merged with the per-(tenant, sysno, stage) latency histograms.

        Counter reads are downstream-first (reap -> completion ->
        submission) and each record is copied under its own Counters lock,
        so the totals always satisfy ``submitted >= completed >= reaped``
        — no transient over-claims, even while submitters, pollers, and
        workers are running full tilt.
        """
        with self._lock:
            ring = self._ring
            sched = self._sched
            tenants = dict(self._tenants)
            tracer = self._tracer
            ext = dict(self._ext_stats)
        # downstream first: reaped before completed before submitted, so
        # monotone counters can only make the invariant slacker, not break
        rings = ([("ring", ring)] if ring is not None else []) + \
            [(t.name, t.ring) for t in tenants.values()]
        cq = {name: r.cq.snapshot() for name, r in rings}
        reaped = sum(s["reaped"] for s in cq.values())
        ex = self.executor.counters.snapshot()
        completed = ex["processed"]
        ring_snaps = {name: r.counters.snapshot() for name, r in rings}
        submitted = ex["interrupts"] + sum(s["submitted"]
                                           for s in ring_snaps.values())
        out = {
            "totals": {"submitted": submitted, "completed": completed,
                       "reaped": reaped},
            "executor": ex,
            "syscalls": self.table.counters.snapshot(),
            "ring": ring_snaps.get("ring"),
            "cq": cq.get("ring"),
            "fuse": (ring.fuse.counters.snapshot()
                     if ring is not None and ring.fuse is not None else None),
            "sched": sched.counters.snapshot() if sched is not None else None,
            # zero-copy data plane: marshalling bytes still copied, by
            # path (trending to ~0 on arena workloads), + arena occupancy
            "copies": self.table.copies.snapshot(),
            "arena": (self.heap.arena_stats()
                      if hasattr(self.heap, "arena_stats") else None),
            "tenants": {},
            "histograms": tracer.histograms() if tracer is not None else {},
            "trace": tracer.meta() if tracer is not None
            else {"enabled": False},
            "serving": {name: c.snapshot() for name, c in ext.items()},
        }
        for name, t in tenants.items():
            out["tenants"][name] = {
                "stats": t.counters.snapshot(),
                "ring": ring_snaps.get(name),
                "cq": cq.get(name),
                "fuse": (t.ring.fuse.counters.snapshot()
                         if t.ring.fuse is not None else None),
            }
        return out

    def export_chrome_trace(self, path: str) -> dict | None:
        """Write the tracer's Chrome-trace/Perfetto JSON to ``path`` (see
        :meth:`Tracer.export_chrome_trace`); no-op when tracing is off."""
        tracer = self._tracer
        if tracer is None:
            return None
        return tracer.export_chrome_trace(path)

    def use_policies(self, *policies) -> PolicyEngine:
        """Install gpu_ext-style QoS policies (sched.Policy instances) on
        the shared engine; they apply to every tenant's submissions and to
        the poller group's reap order."""
        for p in policies:
            self.engine.add(p)
        return self.engine

    def use_fault_plan(self, plan):
        """Arm deterministic fault injection (an
        :class:`~repro_torch.core.genesys.admit.FaultPlan`, or ``None`` to
        disarm): every dispatch — ring batches, fused groups, doorbell
        fallbacks — consults the plan inside the executor's one dispatch
        funnel. Returns the plan for chaining."""
        self.executor.fault_plan = plan
        return plan

    def tenant(self, name: str, *, weight: float = 1.0, priority: int = 0,
               rate_limit: float | None = None, burst: float | None = None,
               n_slots: int | None = None, sq_depth: int | None = None,
               batch_max: int | None = None, fuse: bool = False,
               deadline_us: float | None = None,
               coalesce_max: int | None = None,
               group: str | None = None,
               trace: bool = False) -> Tenant:
        """Get or create the named tenant: a private SyscallRing over a
        carved partition of the slot area, registered with the shared
        PollerGroup and policy engine. Re-requesting a name returns the
        existing tenant (QoS kwargs are only applied on first creation).

        ``fuse=True`` attaches a genesys.fuse Coalescer to the tenant's
        ring: popped bundles get cross-call semantic coalescing (merged
        preads, deduped reads, batched mmaps). ``deadline_us`` is the
        EDF knob the :class:`~repro_torch.core.genesys.sched.Deadline` policy
        reads; ``coalesce_max`` bounds interrupt coalescing for this
        tenant's doorbell-fallback calls; ``group`` names the cgroup-style
        admission/WFQ group the tenant belongs to (tenants sharing a
        group are ONE scheduling entity — see genesys.admit);
        ``trace=True`` turns lifecycle tracing on for this tenant's ring
        (creating the shared tracer on first use even when
        ``GenesysConfig.trace`` is off)."""
        c = self.config
        with self._lock:
            t = self._tenants.get(name)
            if t is not None:
                return t
            ring_fuse = None
            if fuse:
                from repro_torch.core.genesys.fuse import Coalescer
                ring_fuse = Coalescer(max_span=c.fuse_max_span)
            part = self.area.carve(n_slots or c.tenant_slots)
            # fault plans attribute doorbell-fallback dispatches by the
            # slot partition's owner (executor._process reads it back)
            part.owner = str(name)
            # (fallback_coalesce_max is set by Tenant.__init__ from its
            # coalesce_max knob — one mechanism, also covering Tenants
            # constructed directly around an existing ring)
            ring = SyscallRing(
                part, self.executor,
                sq_depth=sq_depth or c.tenant_sq_depth,
                cq_depth=c.tenant_cq_depth,
                batch_max=batch_max or c.ring_batch_max,
                start_poller=False, fuse=ring_fuse)
            if trace or self._tracer is not None:
                ring.trace = self._tracer_locked().channel(name)
            t = Tenant(name, ring, weight=weight, priority=priority,
                       rate_limit=rate_limit, burst=burst, engine=self.engine,
                       deadline_us=deadline_us, coalesce_max=coalesce_max,
                       group=group)
            # per-tenant buffer tracking (Tenant.new_buffer): extents are
            # released when the tenant retires (close_tenant)
            t.heap = self.heap
            self._sched_locked().add(ring, tenant=t)
            self._tenants[name] = t
            return t

    def tenants(self) -> dict[str, Tenant]:
        with self._lock:
            return dict(self._tenants)

    def close_tenant(self, name: str) -> None:
        """Retire a tenant: deregister it from the poller group, flush and
        complete its outstanding SQEs, and return its slot partition to
        the shared area (so tenant churn does not leak slots)."""
        with self._lock:
            t = self._tenants.pop(name, None)
            sched = self._sched
        if t is None:
            return
        if sched is not None:
            sched.remove(t.ring)
        while t.ring.process_pending():    # SQEs no poller will see now
            pass
        self.executor.drain()              # partition slots must be home
        self.area.reclaim(t.area)
        t.release_buffers()                # tracked arena extents go home
        self.engine.closed(t)              # drop per-tenant policy state

    # ------------- registered buffers (io_uring READ_FIXED analogue) ------------
    def register_buffers(self, handles) -> list[int]:
        """Pin heap handles into the syscall table's fixed-buffer index
        table. The returned indices are valid as the buffer argument of
        ``Sys.PREAD64_FIXED`` / ``Sys.RECVFROM_FIXED`` and the gather-side
        ``Sys.PWRITE64_FIXED`` / ``Sys.SENDTO_FIXED``, whose handlers
        index the table directly — no per-call heap hop on the hot path
        (io_uring registered-buffer semantics). Under the default arena
        data plane this pins the extent's backing view, so the extent must
        stay live (unreleased) while its index is in use."""
        return [self.table.register_fixed(self.heap.resolve(h))
                for h in handles]

    # ------------- host-side ring path (genesys.uring) --------------------------
    def ring_call(self, sysno: int, *args, hw_id: int = 0,
                  timeout: float | None = None) -> int:
        """Single syscall through the submission ring; blocks on its
        Completion future (no doorbell interrupt, no slot spin)."""
        return self.ring.submit(sysno, *args, hw_id=hw_id).result(
            timeout=timeout)

    def ring_submit(self, calls, *, want_cqe: bool = False, hw_id: int = 0
                    ) -> list[Completion]:
        """Multi-entry submission: ``calls`` is a list of ``(sysno, *args)``
        tuples; returns one Completion per call (reapable out of order)."""
        return self.ring.submit_many(calls, want_cqe=want_cqe, hw_id=hw_id)

    def ring_reap(self, max_n: int = 64, timeout: float | None = None
                  ) -> list[tuple[int, int]]:
        """Drain up to ``max_n`` (user_data, retval) CQEs in completion
        order (only calls submitted with ``want_cqe=True`` post CQEs)."""
        return self.ring.reap(max_n, timeout=timeout)

    # ------------- device-initiated entry ----------------------------------
    def _host_entry(self, blocking: bool, via_ring: bool,
                    sysno_np, args_np, hw_np):
        """The host entry: post slot(s), ring doorbell or SQ, maybe wait."""
        sysno = int(np.asarray(sysno_np).reshape(()))
        hw = int(np.asarray(hw_np).reshape(()))
        a = np.asarray(args_np)
        batched = a.ndim == 3
        rows = a if batched else a[None]
        # vectorized arg-join: [k,6,2] (lo,hi) int32 -> [k,6] uint64 in two
        # numpy ops, shared by both delivery paths
        joined = _np_join_batch(rows)
        if via_ring:
            comps = self.ring.submit_np(sysno, joined, hw_id=hw)
            if not blocking:
                return np.zeros((len(rows), 2) if batched else (2,), np.int32)
            rets = np.array([_split64(c.result()) for c in comps],
                            dtype=np.int32)
            return rets if batched else rets[0]
        tickets = []
        for r in joined:
            t = self.area.acquire(hw)
            self.area.post(t, sysno, r, blocking)
            self.executor.interrupt(t.slot)
            tickets.append(t)
        if not blocking:
            return np.zeros((len(rows), 2) if batched else (2,), np.int32)
        rets = np.array([_split64(self.area.wait(t)) for t in tickets],
                        dtype=np.int32)
        return rets if batched else rets[0]

    def device_plane(self, device):
        """The device entry's plane on ``device`` (created on first use:
        the mapped slot area, the owner words, the poller)."""
        from repro_torch.core.genesys.device import DevicePlane
        device = torch.device(device)
        with self._lock:
            if self._device is None:
                self._device = DevicePlane(self, device)
            plane = self._device
        if plane.device.type != device.type or (
                device.index is not None
                and plane.device.index != device.index):
            raise ValueError(f"this Genesys invokes from {plane.device}, "
                             f"not {device}")
        return plane

    def _device_entry(self, sysno: int, args: torch.Tensor, *, blocking,
                      via_ring, hw_id: int, ordering):
        """The device entry: a kernel posts one slot per row into mapped
        host memory. Returns the retval tensor and the post-barrier's tag,
        both written by the kernel (None, None if non-blocking): nothing
        more is queued on the caller's stream after the launch, where each
        PyTorch call would hand the GIL to the host plane's threads while
        they answer the card."""
        plane = self._device
        if plane is None or plane.device != args.device:
            plane = self.device_plane(args.device)
        flags = FLAG_BLOCKING if blocking else 0
        if via_ring:
            from repro_torch.core.genesys.device import FLAG_RING
            flags |= FLAG_RING
        rows = (args if args.dim() == 3 else args[None]).contiguous()
        out = tag = None
        if blocking:
            out = torch.empty(args.shape[:-2] + (2,), dtype=torch.int32,
                              device=args.device)
            tag = torch.empty((), dtype=torch.float32, device=args.device)
        current = torch.cuda.current_stream(args.device)
        if ordering != Ordering.RELAXED_CONSUMER:
            plane.post(rows, sysno=sysno, flags=flags, hw_id=hw_id,
                       stream=current, out=out, tag=tag)
            return out, tag
        # no pre-dependency: the side stream waits only for args that may
        # still be in flight on the caller's stream
        if not getattr(args, _ARGS_READY, False):
            plane.side.wait_event(plane.record(current))
        plane.post(rows, sysno=sysno, flags=flags, hw_id=hw_id,
                   stream=plane.side, out=out, tag=tag)
        if blocking:
            # the caller's stream waits for the call, so memory it frees
            # (rows) is reused only after the kernel has read it
            current.wait_event(plane.event(plane.side))
        else:
            rows.record_stream(plane.side)
        return out, tag

    def invoke(self, sysno, args: torch.Tensor, *,
               granularity: Granularity = Granularity.WORK_GROUP,
               ordering: Ordering = Ordering.STRONG,
               blocking: bool = True,
               deps=None, hw_id=0, via_ring: bool = False) -> InvokeResult:
        """Invoke a system call from a device computation.

        ``args``: [6,2] int32 from :func:`pack_args` (or [n,6,2] for
        WORK_ITEM batches — one slot per row). Args on the CPU take the
        host entry; args on a CUDA card take the device entry (a kernel,
        one thread a row), which returns once the call is queued on the
        card: the retval tensor fills when the kernel ends.

        ``via_ring=True`` routes the call through the genesys.uring
        submission ring instead of the doorbell-interrupt path: batched
        WORK_ITEM rows become one multi-entry submission, and blocking
        results are reaped out of order via Completion futures.
        """
        if granularity == Granularity.WORK_ITEM and ordering != Ordering.STRONG:
            raise ValueError(
                "work-item granularity supports only implicit strong ordering "
                "(paper §4.1)")
        if granularity == Granularity.KERNEL and ordering == Ordering.STRONG:
            raise ValueError(
                "strong ordering at kernel granularity can deadlock the "
                "machine (paper §4.1) — use a relaxed ordering")
        ready = getattr(args, _ARGS_READY, False)
        args = torch.as_tensor(args).to(torch.int32)
        batched = args.dim() == 3
        if batched and granularity != Granularity.WORK_ITEM:
            raise ValueError("batched args require WORK_ITEM granularity")

        # pre-barrier: producers (and strong) must wait for prior work
        if deps is not None and ordering in (Ordering.STRONG,
                                             Ordering.RELAXED_PRODUCER):
            args = args + _fold(deps).to(args.device, torch.int32)
        elif ready:
            setattr(args, _ARGS_READY, True)

        sysno, hw_id = int(sysno), int(hw_id)
        if args.device.type == "cpu":
            ret = torch.from_numpy(self._host_entry(
                blocking, via_ring, np.asarray(sysno, np.int32), args.numpy(),
                np.asarray(hw_id)))
            tag = ret.sum().to(torch.float32) * 0.0 if blocking else None
        else:
            ret, tag = self._device_entry(
                sysno, args, blocking=blocking, via_ring=via_ring,
                hw_id=hw_id, ordering=ordering)
        # post-barrier: consumers (and strong) gate downstream work on retval
        if blocking and ordering in (Ordering.STRONG, Ordering.RELAXED_CONSUMER):
            return InvokeResult(retval=ret, _tag=tag)
        return InvokeResult(retval=ret if blocking else None, _tag=None)

"""GENESYS: generic device-initiated system calls (Vesely et al., 2017),
host plane of the PyTorch port (a copy of ``repro.core.genesys`` whose
``invoke`` module keeps the host side only: the device-initiated entry
``Genesys.invoke`` is the next slice of the port).

The public façade is :class:`repro_torch.core.genesys.invoke.Genesys`; semantics
knobs mirror the paper: invocation granularity (WORK_ITEM / WORK_GROUP /
KERNEL), ordering (STRONG / RELAXED_PRODUCER / RELAXED_CONSUMER), blocking
vs non-blocking, and host-side coalescing (window + max batch).

Three CPU-side delivery paths coexist on one `Genesys` instance — choose
by call pattern:

* **doorbell** (paper §5): every call raises an "interrupt" that the
  dispatcher coalesces into worker bundles. Retvals return through the
  slot-state handshake (READY -> PROCESSING -> FINISHED), so a blocking
  caller spins/sleeps on its slot. Choose it for **sparse,
  latency-tolerant calls**, or when the caller needs the paper's exact
  Fig-4 slot semantics.
* **shared ring** (``uring.py`` / ``completion.py``): io_uring-style
  submission/completion rings over the whole slot area. Submissions are
  SQEs; a host poller (now a single-member
  :class:`~repro_torch.core.genesys.sched.PollerGroup`) busy-polls with
  SQPOLL-style adaptive parking and hands whole batches to the worker
  pool. Retvals come back as Completion futures / CQEs, reapable **out of
  order** (paper §8.3), while slots recycle immediately. Choose it for
  **high-rate syscall streams from a single trusted workload** (batched
  reads/writes, one serving loop): per-call cost is two ring operations,
  not an interrupt + two queue hops.
* **per-tenant rings** (``sched.py`` / ``tenant.py``, via
  ``Genesys.tenant(name, ...)``): each tenant gets a private ring over a
  *carved partition* of the slot area, a shared
  :class:`~repro_torch.core.genesys.sched.PolicyEngine` runs gpu_ext-style
  ``on_submit``/``on_full``/``on_reap`` hooks (token-bucket rate limits,
  strict priority, weighted-fair queueing), and a multi-poller
  :class:`~repro_torch.core.genesys.sched.PollerGroup` reaps all tenant SQs in
  QoS order. Choose it when **multiple workloads share one Genesys** — a
  serving loop next to a data-prefetcher, per-client traffic, latency
  tenants next to batch tenants — i.e. whenever one flooding submitter
  must not be able to starve another's syscalls. Slot exhaustion, SQ
  backpressure, rate limiting, and reap bandwidth are all isolated or
  apportioned per tenant.

Ordering guarantees: all paths dispatch to the shared worker pool (or, in
``sched_inline`` SQPOLL mode, the poller threads), so cross-call
completion order is unspecified unless the caller imposes it (Completion
futures, `drain()`, or dataflow deps via `invoke`). Within one ring bundle
calls execute serially in submission order — unless the ring has a
genesys.fuse Coalescer attached (``ring_fuse`` config /
``tenant(..., fuse=True)``), which trades intra-bundle order for merged
kernel crossings: fused group members complete together, with per-call
retvals and buffer contents still bit-exact (weak ordering only, §8.3).
`Genesys.drain()` is the §8.3 barrier over *all* paths, including SQ
entries no poller has seen yet.

Telemetry (``trace.py``): every path is instrumented with lifecycle
events (SUBMIT / SQ_POP / FUSE_MERGE / DISPATCH / COMPLETE / REAP, plus
doorbell IRQ and QoS THROTTLE/REJECT equivalents) recorded into a
fixed-capacity wraparound event ring — off by default, enabled with
``GenesysConfig(trace=True)`` or per tenant via
``Genesys.tenant(name, trace=True)``. Read it three ways:

* ``Genesys.telemetry()`` — one coherent snapshot merging every
  subsystem's counters (executor / ring / sched / fuse / tenants /
  syscall table; each copied under its own ``trace.Counters`` lock, so
  totals always satisfy ``submitted >= completed >= reaped``) with
  vectorized log2-bucket latency histograms per (tenant, sysno, stage):
  ``count`` / ``p50_us`` / ``p99_us`` / ``max_us`` for the queue,
  dispatch, service, total, and reap stages — the per-tenant p99 signal
  the SLO-admission direction consumes;
* ``Genesys.export_chrome_trace(path)`` — Chrome-trace/Perfetto JSON
  with rings, pollers, workers, and tenants as tracks, per-call spans,
  and fused bundles as member-attributed group spans;
* ``trace.format_summary(snapshot)`` — the one-line digest
  ``launch/serve --stats-interval`` prints.

When the event ring wraps, old events are overwritten (histograms cover
the most recent window; ``telemetry()["trace"]["dropped"]`` counts the
loss) and the counters — which never drop — remain exact. The same
no-silent-loss rule applies to the Chrome-trace export: spans elided by
its ``max_spans`` cap are counted in
``trace["metadata"]["dropped_spans"]``.

Metrics (``metrics.py``): where Telemetry is one snapshot, the lazy
``Genesys.metrics`` :class:`~repro_torch.core.genesys.metrics.MetricsRegistry`
is the *time series* over snapshots — windowed counters, gauges, and
log2-bucket latency histograms captured into a fixed ring of windows on
every ``tick()`` (one vectorized array copy, no per-series Python).
First access installs a collector mirroring the full ``telemetry()``
snapshot — totals, per-sysno/per-tenant counters, trace-derived p99
gauges, and every serving source registered via
``Genesys.attach_stats`` (engine, paged KV pool, UDP server) — so
windowed ``rate()`` / ``quantile()`` and the per-tenant SLO
**burn-rate** gauges (``MetricsRegistry.set_slo``) come for free.
Exposition is Prometheus text format, served three ways: a METRICS UDP
op on the serving socket, the ``launch/serve --metrics-port`` TCP
endpoint (:class:`~repro_torch.core.genesys.metrics.MetricsHttpServer`:
``GET /metrics`` scrapes, ``GET /telemetry`` returns the full JSON
snapshot with no datagram ceiling), and ``prometheus_text()`` directly.
Request-scoped tracing ties the layers together: the serving loop
allocates a span id per request, syscalls submitted under
``Tracer.span`` carry it in their SUBMIT aux, the continuous engine
records per-span decode steps, and ``export_chrome_trace`` renders one
pid-5 track per request nesting its steps and syscalls.

Admission & degradation (``admit.py``): the layer that acts on the SLO
signals the two paragraphs above only *measure*. An
:class:`~repro_torch.core.genesys.admit.AdmissionController` is a
:class:`~repro_torch.core.genesys.sched.Policy` (install with
``controller.install(gsys)``) plus a request-classification front end
for the serving loop. Tenants declare **SLO classes**
(:class:`~repro_torch.core.genesys.admit.GroupSpec`: ``slo_us`` / ``target`` /
``priority_class``); the controller registers each as a labeled SLO on
the metrics registry and, on a rate-limited ``refresh()``, reads back
the windowed burn-rate gauges and span-windowed p99 quantiles — never a
raw unwindowed snapshot — to drive one AIMD **shed level**. Priority
classes shed proportionally to rank (protected rank-0 classes are never
shed, only transparently *degraded* — halved token budgets, a small
submit-time delay), and shed requests get an immediate ``SHED_TOKEN``
reply instead of a queue slot, so overload degrades the curve instead
of collapsing it. Cgroup-style **hierarchical groups**
(``Genesys.tenant(name, group=...)``) make N connections from one
customer a single WFQ scheduling node with one burn budget; a
per-tenant **reap-credit ledger** (``SyscallRing.reap_credit``) bounds
how far a slow reaper's completions can outrun its reaping before the
PollerGroup parks that ring (``credit_stalls``) — backpressure instead
of CQ backlog growth. Finally, a deterministic **fault-injection**
plane (:class:`~repro_torch.core.genesys.admit.FaultPlan`, installed via
``Genesys.use_fault_plan``) injects seeded per-(tenant, sysno) errno
schedules at the executor's single dispatch funnel, where transient
errnos (EAGAIN / EINTR) are retried with bounded exponential backoff
(:class:`~repro_torch.core.genesys.executor.RetryPolicy`); the plan's
``digest()`` is bit-reproducible across runs for a fixed seed, making
overload/fault drills replayable in CI.

Zero-copy arena (``arena.py``): the default data plane. Every tenant
buffer is carved from one backing uint8 arena
(:class:`~repro_torch.core.genesys.arena.HostArena`, the default
``Genesys.heap`` unless ``GenesysConfig(arena=False)``), registered at
carve time, and addressed by a generation-tagged handle that fits the
slot ABI's u64 argument words. ``resolve()`` collapses to one
bounds-checked slice; completions land **in place** (``preadv`` /
``recvfrom_into`` straight into the caller's extent, ``pwrite`` /
``sendto`` straight off it); fused reads scatter from an arena scratch
extent with one vectorized strided store per segment; and the serving
reply fanout sends off extents instead of ``tobytes()`` copies. The
residual marshalling is accounted per path and per tenant
(``telemetry()["copies"]``, ``genesys_bytes_copied_total``). Calling
convention for the buffer argument word:

====================  ==========================  =======================
buffer argument       syscalls                    resolved by
====================  ==========================  =======================
arena handle          PREAD64 / PWRITE64 /        ``heap.view(h)`` — one
(``ARENA_BIT`` set)   RECVFROM / SENDTO / READ /  bounds-checked slice of
                      WRITE / MMAP                the backing arena
foreign handle        same                        legacy dict lookup
(small int)                                       (``HostHeap`` shim)
fixed-table index     PREAD64_FIXED /             ``table.fixed(idx)`` —
(``register_fixed``)  PWRITE64_FIXED /            pre-pinned ndarray, no
                      RECVFROM_FIXED /            heap traffic at all
                      SENDTO_FIXED
====================  ==========================  =======================

Arena handles are never revived: ``release`` bumps the extent's
generation, so a straggling call that outlives its buffer resolves dead
(-EIO) instead of touching a re-carved extent. ``release`` is
idempotent on every heap implementation.

Serving (``repro_torch.serving``): the paper's echo server grown into a model
server whose data plane is genesys syscalls end to end. Network I/O is
RECVFROM/SENDTO on tenant rings; the KV cache is a **paged pool**
(:class:`repro_torch.serving.pagedkv.PagedKVPool`) of fixed-size blocks whose
residency is modeled through :class:`MemoryPool` — MMAP at carve, touch
on allocation, MADVISE(DONTNEED) on free — with a block table per
request instead of one contiguous cache per slot. Sealed shared-prefix
blocks are content-addressed (chained hashes), refcounted across
concurrent requests, and LRU-evicted under pressure: eviction PWRITE64s
the block's payload to a spill file and a later prefix hit revives it
with **PREAD64_FIXED into the registered staging buffer, so the decode
read path never pays a heap resolve**. On top sits the
continuous-batching engine (``serving/engine.py``): one fixed decode
shape jitted once, admissions and retirements mid-decode by mutating
block-table rows only, and a split-KV flash-decode kernel
(``kernels/decode_attention.py``) that walks the block table directly.
"""
from repro_torch.core.genesys.admit import (
    AdmissionController, AdmitShed, AdmitStats, FaultPlan, GroupSpec,
)
from repro_torch.core.genesys.area import (
    SyscallArea, SlotState, SLOT_DTYPE, SLOT_BYTES,
)
from repro_torch.core.genesys.completion import Completion, CompletionQueue
from repro_torch.core.genesys.executor import Executor, ExecutorStats, RetryPolicy
from repro_torch.core.genesys.arena import HostArena
from repro_torch.core.genesys.heap import HostHeap
from repro_torch.core.genesys.memory_pool import MemoryPool
from repro_torch.core.genesys.syscalls import (
    CopyStats, Sys, SyscallTable, make_default_table,
)
from repro_torch.core.genesys.fuse import Coalescer, FuseStats
from repro_torch.core.genesys.sched import (
    Deadline, Policy, PolicyEngine, PollerGroup, QosReject, RingPoller,
    SchedStats, StrictPriority, TokenBucket, WeightedFair,
)
from repro_torch.core.genesys.tenant import Tenant, TenantStats
from repro_torch.core.genesys.metrics import (
    MetricsHttpServer, MetricsRegistry, install_genesys_collector,
)
from repro_torch.core.genesys.trace import (
    Counters, EventRing, Tracer, TraceChannel, format_summary,
    latency_histograms, summary_dict,
)
from repro_torch.core.genesys.uring import (
    RingFull, RingStats, SyscallRing,
)
from repro_torch.core.genesys.invoke import (
    Genesys, Granularity, Ordering, GenesysConfig,
)
from repro_torch.core.genesys import table

__all__ = [
    "AdmissionController", "AdmitShed", "AdmitStats", "FaultPlan",
    "GroupSpec",
    "SyscallArea", "SlotState", "SLOT_DTYPE", "SLOT_BYTES",
    "Completion", "CompletionQueue",
    "Executor", "ExecutorStats", "RetryPolicy",
    "HostArena", "HostHeap", "MemoryPool",
    "CopyStats", "Sys", "SyscallTable", "make_default_table",
    "RingFull", "RingPoller", "RingStats", "SyscallRing",
    "Coalescer", "FuseStats",
    "Deadline", "Policy", "PolicyEngine", "PollerGroup", "QosReject",
    "SchedStats", "StrictPriority", "TokenBucket", "WeightedFair",
    "Tenant", "TenantStats",
    "Counters", "EventRing", "Tracer", "TraceChannel",
    "format_summary", "latency_histograms", "summary_dict",
    "MetricsHttpServer", "MetricsRegistry", "install_genesys_collector",
    "Genesys", "Granularity", "Ordering", "GenesysConfig", "table",
]

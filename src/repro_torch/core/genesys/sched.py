"""genesys.sched: pluggable QoS policies and the multi-poller fair reaper.

GENESYS (paper §5-§6) funnels every device syscall through one shared
channel; under multi-tenant load the shared SQ becomes the collapse point —
one flooding workload starves everyone else's syscalls. This module is the
scheduling layer that fixes it:

  * each :class:`~repro_torch.core.genesys.tenant.Tenant` owns its own
    :class:`~repro_torch.core.genesys.uring.SyscallRing` over a *partition* of the
    :class:`~repro_torch.core.genesys.area.SyscallArea`
    (:meth:`SyscallArea.carve`), so admission, SQ backpressure, and slot
    exhaustion are all per-tenant;
  * a :class:`PolicyEngine` runs gpu_ext-style hooks — ``on_submit`` /
    ``on_full`` / ``on_reap`` — so admission, throttling, and priority
    decisions are pluggable code, not hard-wired queue behaviour. Three
    policies ship: :class:`TokenBucket` (submission-side rate limiting),
    :class:`StrictPriority` (latency tenants reap first), and
    :class:`WeightedFair` (WFQ virtual-time credit accounting per tenant
    and per sysno);
  * a :class:`PollerGroup` replaces the single-ring ``RingPoller``: N
    poller threads reap across all tenant SQs in policy order (WFQ vtime
    ascending under :class:`WeightedFair`, priority first under
    :class:`StrictPriority`, round-robin otherwise), re-evaluating the
    order between per-tenant quanta so a latency tenant's SQE never waits
    behind more than one quantum of a batch tenant's backlog.

Poller modes: the default hands popped bundles to the shared
:class:`~repro_torch.core.genesys.executor.Executor` worker pool (one queue op
per bundle, same ``drain()`` barrier as the doorbell path);
``inline=True`` is io_uring SQPOLL's do-the-work-in-the-poller mode — the
poller thread dispatches the bundle itself, which keeps latency tenants
out of the shared worker queue and lets reap throughput scale with poller
count when handlers block (sleep/IO releases the GIL).

Idle pollers park exactly like the single-ring reaper did: after
``spin_polls`` empty rounds they arm every member ring's ``need_wakeup``
flag and wait on one shared event; the first submitter to make any SQ
non-empty delivers one edge-triggered wakeup for the whole group.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.genesys.trace import Counters


class QosReject(RuntimeError):
    """A policy refused admission of a submission (e.g. rate limit in
    ``reject`` mode). Nothing was submitted."""


class Policy:
    """Base class for gpu_ext-style scheduling hooks.

    Subclasses override any subset; every hook has a no-op default so a
    policy can care about exactly one decision point.

      * ``on_submit(tenant, calls)`` — admission: return ``None`` to admit
        immediately, a float to delay the submitter that many seconds
        (throttle), or raise :class:`QosReject` to refuse;
      * ``on_full(tenant, overflow)`` — the tenant's SQ lacks space for
        ``overflow`` entries: return a ``sq_full`` backpressure policy name
        (``"spin"`` / ``"doorbell"`` / ``"raise"``) or ``None`` to defer;
      * ``on_reap(tenant, entries)`` — a poller popped ``entries``
        (``(slot, user_data, flags, sysno)`` tuples) from the tenant's SQ:
        charge credits / update accounting;
      * ``on_abort(tenant, calls)`` — a submission this policy's
        ``on_submit`` already saw was never submitted after all (a later
        policy rejected it, or the ring raised
        :class:`~repro_torch.core.genesys.uring.RingFull`): roll back any
        per-submission state;
      * ``on_fallback(tenant, n)`` — ``n`` calls of an admitted
        submission overflowed the tenant's SQ onto the doorbell path, so
        they will never appear in ``on_reap``: settle their accounting;
      * ``order_key(tenant)`` — sort key contribution for poller visit
        order (ascending); ``None`` means no opinion;
      * ``quantum(tenant, default)`` — bound how many SQEs one poller
        visit may pop from this tenant; ``None`` means no opinion;
      * ``on_close(tenant)`` — the tenant is being retired
        (:meth:`Genesys.close_tenant`): drop its accounting state.
    """

    def on_submit(self, tenant, calls):
        return None

    def on_full(self, tenant, overflow: int):
        return None

    def on_abort(self, tenant, calls) -> None:
        pass

    def on_fallback(self, tenant, n: int) -> None:
        pass

    def on_reap(self, tenant, entries) -> None:
        pass

    def order_key(self, tenant):
        return None

    def quantum(self, tenant, default: int):
        return None

    def on_close(self, tenant) -> None:
        pass


class PolicyEngine:
    """Ordered chain of :class:`Policy` hooks shared by all tenants.

    Admission delays combine by max; the first policy with an ``on_full``
    opinion wins; visit order sorts by the tuple of every policy's
    ``order_key``, in chain order (so ``StrictPriority`` before
    ``WeightedFair`` means priority dominates and vtime tie-breaks).
    """

    def __init__(self, policies=()):
        self.policies: list[Policy] = list(policies)

    def add(self, policy: Policy) -> "PolicyEngine":
        self.policies.append(policy)
        return self

    def admit(self, tenant, calls) -> float:
        """Run every ``on_submit`` hook; returns the delay (seconds) the
        submitter must pay, 0.0 for immediate admission. Raises
        :class:`QosReject` if any policy refuses — after unwinding the
        hooks that already ran (their ``on_abort``), so a reject leaks no
        per-submission state out of earlier policies in the chain."""
        delay = 0.0
        ran: list[Policy] = []
        for p in self.policies:
            try:
                d = p.on_submit(tenant, calls)
            except QosReject:
                for q in reversed(ran):
                    q.on_abort(tenant, calls)
                raise
            ran.append(p)
            if d is not None:
                delay = max(delay, float(d))
        return delay

    def aborted(self, tenant, calls) -> None:
        """An admitted submission was never submitted (e.g. RingFull):
        every policy rolls back its per-submission state."""
        for p in self.policies:
            p.on_abort(tenant, calls)

    def fell_back(self, tenant, n: int) -> None:
        """``n`` admitted calls overflowed onto the doorbell path and will
        never be reaped off the SQ; policies settle their accounting."""
        for p in self.policies:
            p.on_fallback(tenant, n)

    def overflow_policy(self, tenant, overflow: int) -> str | None:
        for p in self.policies:
            o = p.on_full(tenant, overflow)
            if o is not None:
                return o
        return None

    def reaped(self, tenant, entries, charged=None) -> None:
        """``entries`` is what was actually popped (true call counts —
        Deadline retires stamps against it); ``charged`` is the planned
        batch's fuse-aware QoS view (one entry per kernel crossing, see
        ``SyscallRing.plan``). Policies exposing ``on_reap_charged`` get
        both; everyone else sees the true entries."""
        for p in self.policies:
            f = getattr(p, "on_reap_charged", None)
            if f is not None and charged is not None:
                f(tenant, entries, charged)
            else:
                p.on_reap(tenant, entries)

    def closed(self, tenant) -> None:
        for p in self.policies:
            p.on_close(tenant)

    def order(self, members) -> list:
        """Sort poll-group members (objects with a ``.tenant`` attribute)
        into visit order; members without a tenant keep neutral keys."""
        if not self.policies:
            return list(members)

        def key(m):
            t = m.tenant
            if t is None:
                return tuple(0 for _ in self.policies)
            return tuple(
                k if (k := p.order_key(t)) is not None else 0
                for p in self.policies)

        return sorted(members, key=key)

    def quantum(self, tenant, default: int) -> int:
        q = int(default)
        if tenant is not None:
            for p in self.policies:
                pq = p.quantum(tenant, default)
                if pq is not None:
                    q = min(q, int(pq))
        return max(1, q)


class TokenBucket(Policy):
    """Submission-side rate limiting: each tenant refills
    ``tenant.rate_limit`` tokens/second up to ``tenant.burst``, one token
    per call. Tenants without a ``rate_limit`` are unlimited.

    ``mode="throttle"`` (default) admits into debt and returns the time
    until the bucket is whole again — the submitter sleeps, which paces a
    flooder to its configured rate. ``mode="reject"`` refuses (and does
    not charge) submissions the bucket cannot cover.

    ``sysno_rates={sysno: (rate, burst)}`` adds per-sysno buckets on top
    (e.g. cap SENDTO independently of PREAD64), charged per tenant.
    """

    def __init__(self, *, sysno_rates=None, mode: str = "throttle"):
        if mode not in ("throttle", "reject"):
            raise ValueError(f"mode must be throttle|reject, got {mode!r}")
        self.mode = mode
        self.sysno_rates = {int(k): (float(r), float(b))
                            for k, (r, b) in (sysno_rates or {}).items()}
        self._lock = threading.Lock()
        self._buckets: dict = {}    # key -> [tokens, last_refill_monotonic]

    def _refilled(self, key, rate: float, burst: float, now: float) -> float:
        tokens, stamp = self._buckets.get(key, (burst, now))
        return min(burst, tokens + (now - stamp) * rate)

    def on_submit(self, tenant, calls):
        # two-phase: plan every involved bucket's charge first, commit
        # only if the whole submission is admitted — a reject must not
        # leak tokens out of sibling buckets (nothing was submitted)
        plan = self._charge_plan(tenant, calls)
        if not plan:
            return None
        delay = 0.0
        with self._lock:
            # clock read under the lock: commits are ordered, so a racing
            # submitter can never store an older stamp over a newer one
            # (which would silently destroy refill credit)
            now = time.monotonic()
            refilled = [self._refilled(key, rate, burst, now)
                        for key, _need, rate, burst in plan]
            if self.mode == "reject":
                for (key, need, _r, _b), tokens in zip(plan, refilled):
                    if tokens < need:
                        for (k2, _n2, r2, b2), t2 in zip(plan, refilled):
                            self._buckets[k2] = [t2, now]   # refill only
                        raise QosReject(
                            f"rate limit: {key} has {tokens:.1f} tokens, "
                            f"need {need:.0f}")
            for (key, need, rate, _b), tokens in zip(plan, refilled):
                tokens -= need
                self._buckets[key] = [tokens, now]
                if tokens < 0:
                    delay = max(delay, -tokens / rate)
        return delay or None

    def _charge_plan(self, tenant, calls) -> list[tuple]:
        """The ``(key, amount, rate, burst)`` charges this submission
        involves — shared by on_submit (commit) and on_abort (refund)."""
        plan: list[tuple] = []
        n = len(calls)
        if getattr(tenant, "rate_limit", None):
            rate = float(tenant.rate_limit)
            burst = float(tenant.burst or max(rate, 1.0))
            plan.append((tenant.name, float(n), rate, burst))
        for sysno, (rate, burst) in self.sysno_rates.items():
            k = sum(1 for c in calls if int(c[0]) == sysno)
            if k:
                plan.append(((tenant.name, sysno), float(k), rate, burst))
        return plan

    def on_abort(self, tenant, calls) -> None:
        """The charged submission never happened (a later policy rejected
        it, or the ring raised RingFull): hand the tokens back — capped at
        burst — so failed submissions don't throttle future real work."""
        plan = self._charge_plan(tenant, calls)
        if not plan:
            return
        with self._lock:
            for key, back, _rate, burst in plan:
                b = self._buckets.get(key)
                if b is not None:
                    b[0] = min(burst, b[0] + back)


class StrictPriority(Policy):
    """Reap-side strict priority: pollers visit higher-``priority``
    tenants first (RTGPU-style — latency-critical tenants are never stuck
    behind batch tenants in the visit order)."""

    def order_key(self, tenant):
        return -int(getattr(tenant, "priority", 0))


class Deadline(Policy):
    """EDF (earliest-deadline-first) reap order, built on ``order_key``.

    Tenants with a ``deadline_us`` knob get an absolute deadline stamped
    per admitted submission (``now + deadline_us``); pollers visit the
    tenant whose *earliest outstanding* deadline is nearest first, so a
    near-deadline tenant's SQEs are reaped before everyone else's backlog
    regardless of arrival order. Tenants without a deadline sort last
    (after every deadline tenant). Reaps retire deadlines FIFO — the ring
    pops in submission order, so the oldest stamps go first.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # tenant name -> deque of [abs_deadline_monotonic, n_calls]
        self._pending: dict[str, object] = {}

    def on_submit(self, tenant, calls):
        d_us = getattr(tenant, "deadline_us", None)
        if not d_us:
            return None
        stamp = time.monotonic() + float(d_us) / 1e6
        with self._lock:
            q = self._pending.get(tenant.name)
            if q is None:
                q = self._pending[tenant.name] = deque()
            q.append([stamp, len(calls)])
        return None

    def order_key(self, tenant):
        with self._lock:
            q = self._pending.get(tenant.name)
            if q:
                return q[0][0]
        return float("inf")     # no outstanding deadline: visit last

    def on_reap(self, tenant, entries) -> None:
        k = len(entries)
        with self._lock:
            q = self._pending.get(tenant.name)
            while k > 0 and q:
                head = q[0]
                take = min(k, head[1])
                head[1] -= take
                k -= take
                if head[1] == 0:
                    q.popleft()

    def on_abort(self, tenant, calls) -> None:
        """The stamped submission never reached the SQ (rejected by a
        later policy, or RingFull): retire its stamp — the newest one of
        matching size — or a stale deadline would pin this tenant first
        in the visit order forever."""
        self._retire_newest(tenant.name, len(calls))

    def on_fallback(self, tenant, n: int) -> None:
        """``n`` tail calls of the newest submission bypassed the SQ via
        the doorbell; they will never be reaped, so their share of the
        stamp must retire now."""
        self._retire_newest(tenant.name, n)

    def _retire_newest(self, name: str, k: int) -> None:
        with self._lock:
            q = self._pending.get(name)
            while k > 0 and q:
                tail = q[-1]
                take = min(k, tail[1])
                tail[1] -= take
                k -= take
                if tail[1] == 0:
                    q.pop()

    def on_close(self, tenant) -> None:
        with self._lock:
            self._pending.pop(tenant.name, None)


class WeightedFair(Policy):
    """Weighted-fair-queueing credit accounting per WFQ *node* and sysno.

    A node is the tenant's ``group`` name when set (cgroup-style: a
    customer with 50 connections is 50 tenants sharing ONE node, one
    vtime, one quantum budget — a single scheduling entity) and the
    tenant's own name otherwise. Every reaped entry charges
    ``costs.get(sysno, 1.0) / weight`` of virtual time to the node;
    pollers visit tenants in ascending node vtime, so over any busy
    interval *node* throughput converges to the weight ratio regardless
    of how many connections a node splits itself into. The per-(node,
    sysno) cumulative charges are kept in :attr:`charged` — the
    accounting ledger a billing/debug layer can read.

    Fuse-aware costing: when the poller hands over a planned batch's
    ``qos_entries()`` (via ``on_reap_charged``), charges count kernel
    *crossings* — a Coalescer-merged read group of 32 adjacent preads
    charges one crossing, not 32.

    The quantum hook scales each visit's pop bound by
    ``node_weight / max_node_weight``: a weight-1 node next to a
    weight-32 node contributes at most ``batch_max/32`` entries of
    head-of-line blocking per visit.
    """

    def __init__(self, costs=None):
        self.costs = {int(k): float(v) for k, v in (costs or {}).items()}
        self._lock = threading.Lock()
        self.vtime: dict[str, float] = {}                # node -> vtime
        self.charged: dict[str, dict[int, float]] = {}   # node -> ledger
        self._weights: dict[str, float] = {}   # live nodes' weights
        self._members: dict[str, dict[str, float]] = {}  # node -> members

    @staticmethod
    def _node(tenant) -> str:
        return getattr(tenant, "group", None) or tenant.name

    def order_key(self, tenant):
        with self._lock:
            return self.vtime.get(self._node(tenant), 0.0)

    def quantum(self, tenant, default: int):
        node = self._node(tenant)
        w = float(getattr(tenant, "weight", 1.0))
        with self._lock:
            members = self._members.setdefault(node, {})
            members[tenant.name] = w
            # the node's weight is its heaviest live member's — a group
            # does not grow scheduling share by opening more connections
            self._weights[node] = max(members.values())
            # max over *live* nodes: a closed heavyweight must not keep
            # everyone else's quantum shrunken forever
            ratio = self._weights[node] / max(
                max(self._weights.values()), 1.0)
        return max(1, int(default * ratio))

    def on_close(self, tenant) -> None:
        node = self._node(tenant)
        with self._lock:
            members = self._members.get(node)
            if members is not None:
                members.pop(tenant.name, None)
            if members:
                self._weights[node] = max(members.values())
                return      # siblings keep the node's vtime/ledger alive
            self._members.pop(node, None)
            self._weights.pop(node, None)
            self.vtime.pop(node, None)
            self.charged.pop(node, None)

    def on_reap(self, tenant, entries) -> None:
        self._charge(tenant, entries)

    def on_reap_charged(self, tenant, entries, charged) -> None:
        """Fuse-aware reap: vtime/ledger charges come from the planned
        batch's kernel-crossing view, not the raw popped entries."""
        self._charge(tenant, charged)

    def _charge(self, tenant, entries) -> None:
        node = self._node(tenant)
        w = max(float(getattr(tenant, "weight", 1.0)), 1e-9)
        with self._lock:
            if node in self._weights:
                w = max(self._weights[node], 1e-9)
            ledger = self.charged.setdefault(node, {})
            cost = 0.0
            for _slot, _ud, _fl, sysno in entries:
                c = self.costs.get(sysno, 1.0)
                cost += c
                ledger[sysno] = ledger.get(sysno, 0.0) + c
            # WFQ vtime clamp, applied on a node's FIRST charge only: a
            # node created late starts from the lagging incumbent's
            # vtime, not from zero — otherwise it would monopolize the
            # pollers until it "caught up" with incumbents' historic
            # charges. Continuously-active nodes are never clamped, so
            # a laggard keeps the preference it legitimately earned.
            if node in self.vtime:
                base = self.vtime[node]
            else:
                others = list(self.vtime.values())
                base = min(others) if others else 0.0
            self.vtime[node] = base + cost / w


@dataclass
class SchedStats:
    rounds: int = 0             # poll rounds (one order evaluation each)
    served_bundles: int = 0
    served_entries: int = 0
    idle_rounds: int = 0
    parks: int = 0              # times the group armed wakeups and slept
    wakeups: int = 0            # parks ended by a submitter's edge wakeup
    per_tenant: dict = field(default_factory=dict)   # name -> entries reaped


class _Member:
    __slots__ = ("ring", "tenant")

    def __init__(self, ring, tenant=None):
        self.ring = ring
        self.tenant = tenant


class PollerGroup:
    """N poller threads reaping M rings in QoS order.

    The multi-tenant successor of the single-ring ``RingPoller``: each
    round a poller asks the :class:`PolicyEngine` for the tenant visit
    order, pops at most one *quantum* of SQEs from the first non-empty
    ring, dispatches them (worker handoff or inline), charges the reap
    hooks, and re-evaluates — so priority/vtime changes take effect at
    quantum granularity. With no engine the order is round-robin and the
    quantum is each ring's ``batch_max`` (exactly the old behaviour).
    """

    def __init__(self, rings=(), *, n_pollers: int = 1, spin_polls: int = 64,
                 max_sleep_s: float = 0.002, engine: PolicyEngine | None = None,
                 inline: bool = False, name: str = "genesys-sched"):
        self.engine = engine
        self.inline = bool(inline)
        self.n_pollers = max(1, int(n_pollers))
        self.spin_polls = max(1, int(spin_polls))
        self.max_sleep_s = float(max_sleep_s)
        self.name = name
        self.counters = Counters(SchedStats())
        self.stats = self.counters.stats
        self._members: list[_Member] = []
        self._members_lock = threading.Lock()
        self._rr = 0
        self._wakeup = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        if hasattr(rings, "pop_entries"):    # a single ring, not an iterable
            rings = (rings,)
        for r in rings:
            self.add(r)

    # -- membership -----------------------------------------------------------
    def add(self, ring, tenant=None) -> None:
        """Register a ring (optionally owned by a tenant). The ring's
        SQPOLL wakeup is re-pointed at this group's shared event so any
        submitter's empty->nonempty edge wakes a parked poller."""
        ring._wakeup = self._wakeup
        with self._members_lock:
            self._members.append(_Member(ring, tenant))
        self._wakeup.set()      # running pollers re-snapshot next round

    def remove(self, ring) -> None:
        with self._members_lock:
            self._members = [m for m in self._members if m.ring is not ring]

    def _snapshot(self) -> list[_Member]:
        with self._members_lock:
            return list(self._members)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._loop, name=f"{self.name}-poll-{i}",
                             daemon=True)
            for i in range(self.n_pollers)
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for m in self._snapshot():
            with m.ring._sq_lock:
                m.ring._need_wakeup = False
        self._wakeup.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads = []

    # -- the poll loop --------------------------------------------------------
    def _poll_once(self) -> int:
        """One round: visit members in policy order, reap one quantum from
        the first non-empty ring. Returns entries reaped (0 = idle)."""
        members = self._snapshot()
        if not members:
            return 0
        if self.engine is not None and self.engine.policies:
            ordered = self.engine.order(members)
        else:
            i = self._rr % len(members)
            self._rr += 1                   # benign race: any rotation works
            ordered = members[i:] + members[:i]
        for m in ordered:
            default_q = m.ring.batch_max
            q = (self.engine.quantum(m.tenant, default_q)
                 if self.engine is not None else default_q)
            if m.tenant is not None:
                # bounded reap-credit ledger (per-tenant CQ backpressure):
                # never pop more than the tenant's CQ can absorb, and skip
                # the ring entirely when its reaper has let credit run dry
                # — a slow reaper stalls ITS ring at ~cq_depth outstanding
                # CQEs; it cannot wedge the group or grow an unbounded CQ
                # backlog. The global (tenant-less) ring keeps the old
                # spill-to-backlog semantics.
                credit = m.ring.reap_credit()
                if credit <= 0:
                    m.ring.counters.add(credit_stalls=1)
                    continue
                q = min(q, credit)
            entries = m.ring.pop_entries(q)
            if not entries:
                m.ring.counters.add(empty_polls=1)
                continue
            batch = m.ring.plan(entries)
            charge = (batch.qos_entries()
                      if self.engine is not None and m.tenant is not None
                      else None)
            m.ring.dispatch_batch(batch, inline=self.inline)
            if self.engine is not None and m.tenant is not None:
                self.engine.reaped(m.tenant, entries, charged=charge)
            n = len(entries)

            def _acct(s, m=m, n=n):
                s.served_bundles += 1
                s.served_entries += n
                if m.tenant is not None:
                    pt = s.per_tenant
                    pt[m.tenant.name] = pt.get(m.tenant.name, 0) + n
            self.counters.update(_acct)
            if m.tenant is not None:
                # the tenant's own counters, under the tenant's own lock
                # (no more cross-module writes under the poller's lock)
                m.tenant.counters.add(reaped=n)
            return n
        return 0

    def _loop(self) -> None:
        idle = 0
        while not self._stop.is_set():
            n = self._poll_once()
            if n == 0:
                self.counters.add(rounds=1, idle_rounds=1)
            else:
                self.counters.add(rounds=1)
            if n:
                idle = 0
                continue
            idle += 1
            if idle < self.spin_polls:
                time.sleep(0)          # busy-poll phase: just yield the GIL
                continue
            # adaptive park: arm every ring's need_wakeup, sleep on the
            # shared event until a submitter's edge wakeup (or a bounded
            # timeout, so shutdown and membership races stay safe)
            members = self._snapshot()
            self._wakeup.clear()
            armed = True
            for m in members:
                with m.ring._sq_lock:
                    if m.ring._sq_tail != m.ring._sq_head:
                        armed = False      # raced: work arrived; don't park
                        break
                    m.ring._need_wakeup = True
            if not armed:
                for m in members:
                    with m.ring._sq_lock:
                        m.ring._need_wakeup = False
                idle = 0
                continue
            self.counters.add(parks=1)
            if self._wakeup.wait(timeout=self.max_sleep_s):
                self.counters.add(wakeups=1)
            for m in members:
                with m.ring._sq_lock:
                    m.ring._need_wakeup = False
            idle = 0


class RingPoller(PollerGroup):
    """Single-ring, single-thread poller — the original ``genesys.uring``
    reaper, kept as the degenerate :class:`PollerGroup`."""

    def __init__(self, ring, *, spin_polls: int = 64,
                 max_sleep_s: float = 0.002):
        super().__init__(ring, n_pollers=1, spin_polls=spin_polls,
                         max_sleep_s=max_sleep_s, name="genesys-uring")

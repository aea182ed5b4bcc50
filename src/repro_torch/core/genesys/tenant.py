"""genesys.tenant: a tenant's private syscall ring + QoS identity.

A :class:`Tenant` bundles the three things the scheduler needs to isolate
one workload from another:

  * a private :class:`~repro_torch.core.genesys.uring.SyscallRing` over a carved
    partition of the shared :class:`~repro_torch.core.genesys.area.SyscallArea`
    (:meth:`SyscallArea.carve`) — slot exhaustion and SQ backpressure are
    per-tenant, so a flooding tenant jams only its own ring;
  * QoS parameters the shipped policies read: ``weight`` (WFQ share),
    ``priority`` (strict-priority reap order), ``rate_limit``/``burst``
    (token-bucket admission);
  * per-tenant :class:`TenantStats` so throttling and reap accounting are
    attributable.

Every submission runs the :class:`~repro_torch.core.genesys.sched.PolicyEngine`'s
``on_submit`` hooks first (sleep the returned delay = throttle; raise
:class:`~repro_torch.core.genesys.sched.QosReject` = refuse), and consults
``on_full`` when its SQ lacks space. Completion semantics are the ring's:
Completion futures, optional CQEs, out-of-order reap, and the shared
executor ``drain()`` barrier all behave exactly as on the global ring.

Construct tenants through :meth:`Genesys.tenant`, which carves the
partition, registers the ring with the shared
:class:`~repro_torch.core.genesys.sched.PollerGroup`, and wires the engine.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.genesys.area import SyscallArea
from repro_torch.core.genesys.completion import Completion
from repro_torch.core.genesys.sched import PolicyEngine, QosReject
from repro_torch.core.genesys.trace import Counters, EV_REJECT, EV_THROTTLE
from repro_torch.core.genesys.uring import SyscallRing


@dataclass
class TenantStats:
    submitted: int = 0          # calls that entered this tenant's ring
    throttled: int = 0          # calls that paid a QoS admission delay
    throttle_s: float = 0.0     # total admission delay slept
    rejected: int = 0           # calls refused by a policy (QosReject)
    sq_full_events: int = 0     # submissions that hit a full SQ
    reaped: int = 0             # entries pulled off the SQ by pollers
    per_sysno: dict = field(default_factory=dict)   # sysno -> submitted


class Tenant:
    """One workload's identity on the scheduler: ring + QoS knobs + stats."""

    def __init__(self, name: str, ring: SyscallRing, *,
                 weight: float = 1.0, priority: int = 0,
                 rate_limit: float | None = None, burst: float | None = None,
                 engine: PolicyEngine | None = None,
                 deadline_us: float | None = None,
                 coalesce_max: int | None = None,
                 group: str | None = None):
        self.name = str(name)
        self.ring = ring
        # fault plans (admit.FaultPlan) key errno schedules on the ring's
        # owning tenant, whichever dispatch path a call takes
        ring.owner = self.name
        self.area: SyscallArea = ring.area       # the carved partition
        # cgroup-style admission/WFQ group: tenants sharing a group name
        # share ONE WeightedFair node (one vtime, one quantum budget) and
        # one admission burn budget; None = this tenant is its own node
        self.group = None if group is None else str(group)
        self.weight = float(weight)
        self.priority = int(priority)
        self.rate_limit = rate_limit
        self.burst = burst
        # EDF reap-order knob (sched.Deadline): submissions from this
        # tenant want service within deadline_us of admission
        self.deadline_us = deadline_us
        # per-tenant interrupt-coalescing bound for doorbell fallbacks
        # (the paper's coalesce_max sysfs knob, tenant-scoped); the ring
        # carries it to Executor.interrupt on the SQ-full path
        self.coalesce_max = coalesce_max
        if coalesce_max is not None:
            ring.fallback_coalesce_max = int(coalesce_max)
        self.engine = engine if engine is not None else PolicyEngine()
        # submit() may be called from many threads; Counters gives every
        # mutation and snapshot the same lock (trace.Counters discipline)
        self.counters = Counters(TenantStats())
        self.stats = self.counters.stats
        # data-plane identity: Genesys.tenant() wires the shared heap so
        # per-tenant buffers (arena extents) are tracked here and released
        # on retire — tenant churn cannot leak extents
        self.heap = None
        self._buffers: list[int] = []

    # -- per-tenant buffers ------------------------------------------------------
    def new_buffer(self, nbytes: int) -> int:
        """Carve a tracked arena buffer owned by this tenant; everything
        carved here is released by :meth:`release_buffers` when the tenant
        retires (Genesys.close_tenant) — the audited fix for serving paths
        that registered per-request buffers and never released them."""
        if self.heap is None:
            raise RuntimeError(f"tenant {self.name!r} has no heap wired")
        h = self.heap.new_buffer(int(nbytes))
        self._buffers.append(h)
        return h

    def release_buffers(self) -> None:
        """Release every tracked buffer (idempotent — release of a dead
        handle is a no-op by the heap contract)."""
        if self.heap is None:
            return
        bufs, self._buffers = self._buffers, []
        for h in bufs:
            self.heap.release(h)

    # -- submission ------------------------------------------------------------
    def submit(self, calls, *, want_cqe: bool = False, hw_id: int = 0,
               sq_full: str | None = None) -> list[Completion]:
        """Submit ``(sysno, *args)`` calls through the QoS hooks, then the
        tenant's ring. Raises :class:`QosReject` (nothing submitted) if a
        policy refuses; sleeps the admission delay if one throttles.

        ``sq_full=None`` lets the engine's ``on_full`` hook pick the
        backpressure policy when the SQ lacks space (default ``"spin"``).
        """
        if not calls:
            return []
        n = len(calls)
        tr = self.ring.trace
        try:
            delay = self.engine.admit(self, calls)
        except QosReject:
            self.counters.add(rejected=n)
            if tr is not None:
                tr.rec(EV_REJECT, int(calls[0][0]), tr.next_seq(), aux=n)
            raise
        if delay > 0:
            self.counters.add(throttled=n, throttle_s=delay)
            if tr is not None:
                tr.rec(EV_THROTTLE, int(calls[0][0]), tr.next_seq(),
                       aux=int(delay * 1e6))
            time.sleep(delay)
        if sq_full is None:
            sq_full = "spin"
            deficit = n - self.ring.sq_space()
            if deficit > 0:
                self.counters.add(sq_full_events=1)
                sq_full = self.engine.overflow_policy(self, deficit) or "spin"
        # pre-account the submission, roll back on failure: submitted only
        # ever leads completion, so a concurrent snapshot can never show
        # reaped > submitted for this tenant

        def _acct(s, sign=1):
            s.submitted += sign * n
            per = s.per_sysno
            for c in calls:
                sn = int(c[0])
                per[sn] = per.get(sn, 0) + sign
        self.counters.update(_acct)
        # fallback_out gives THIS submission's doorbell-fallback count;
        # diffing the ring's shared counter would misattribute concurrent
        # submitters' fallbacks and double-retire policy state
        fb: list = []
        try:
            comps = self.ring.submit_many(calls, want_cqe=want_cqe,
                                          hw_id=hw_id, sq_full=sq_full,
                                          fallback_out=fb)
        except Exception:
            # nothing was submitted (RingFull et al.): policies roll back
            # per-submission state (e.g. a Deadline stamp) or it would
            # skew the reap order forever — and the pre-account unwinds
            self.engine.aborted(self, calls)
            self.counters.update(lambda s: _acct(s, sign=-1))
            raise
        fb_delta = sum(fb)
        if fb_delta > 0:
            # overflow calls rode the doorbell: pollers will never reap
            # them off the SQ, so reap-side policy accounting settles now
            self.engine.fell_back(self, fb_delta)
        return comps

    def call(self, sysno: int, *args, hw_id: int = 0,
             timeout: float | None = None) -> int:
        """One syscall through the tenant ring; blocks on its Completion."""
        return self.submit([(sysno, *args)], hw_id=hw_id)[0].result(
            timeout=timeout)

    # -- reaping ---------------------------------------------------------------
    def reap(self, max_n: int = 64, timeout: float | None = None
             ) -> list[tuple[int, int]]:
        """Drain up to ``max_n`` of this tenant's CQEs (completion order)."""
        return self.ring.reap(max_n, timeout=timeout)

    def close(self) -> None:
        """Flush SQEs still sitting in this tenant's SQ onto the worker
        pool. NOTE: this does not deregister the tenant — use
        :meth:`Genesys.close_tenant`, which also detaches the ring from
        the shared poller group and reclaims the slot partition."""
        self.ring.close()
        self.release_buffers()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Tenant({self.name!r}, w={self.weight}, "
                f"prio={self.priority}, rate={self.rate_limit})")

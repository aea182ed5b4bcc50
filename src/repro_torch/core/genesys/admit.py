"""genesys.admit: SLO-driven admission control, load shedding, graceful
degradation — and deterministic fault injection to regression-gate it.

fig9 proves per-tenant isolation for a handful of tenants; production
(the ROADMAP north star) means thousands, where overload must be shed
*before* it queues and transient kernel-side failures must not cascade.
This module is the control plane layered on the mechanisms that already
exist:

  * :class:`AdmissionController` — a :class:`~repro_torch.core.genesys.sched.Policy`
    that accepts per-group SLO declarations (``slo_us``, ``target``,
    ``priority_class``) and makes admit / degrade / shed decisions at
    submit time. Its input signal is the windowed ``genesys.metrics``
    state (PR 8): per-group ``genesys_slo_burn_rate`` gauges and
    ``MetricsRegistry.quantile(..., span=k)`` windowed p99s — never the
    unwindowed all-time ``trace._tenant_p99s`` snapshot. The controller
    runs one AIMD *shed level* in [0, 1]: protected-group SLO pressure
    (burn rate or p99/SLO ratio above ``raise_burn``) raises it
    multiplicatively-ish (step scaled by pressure), quiet periods decay
    it — and each unprotected group sheds ``level * rank / max_rank`` of
    its traffic, so the measured degradation curve is monotone in
    ``priority_class`` while protected groups (rank <= 0) are never shed.
    Thinning is deterministic (a per-group admit counter, not a PRNG),
    so a fixed request schedule yields a fixed shed pattern.
  * **hierarchical tenant groups** — cgroup-style: every tenant carries
    an optional ``group`` name, and :class:`~repro_torch.core.genesys.sched.WeightedFair`
    keys its vtime/charge/weight state by that group, so a "customer"
    with 50 connections is ONE scheduling entity with one WFQ node and
    one burn budget (the controller's histograms are per group, too).
  * :class:`FaultPlan` — seeded, deterministic per-(tenant, sysno) errno
    schedules (EIO / EAGAIN / EINTR) injected inside
    :meth:`Executor.dispatch_call`, which every dispatch path funnels
    through (ring batches, fused groups, doorbell fallbacks). Verdicts
    are a keyed hash of ``(seed, tenant, sysno, call_index)`` — not
    Python's randomized ``hash()`` and not a shared PRNG stream — so a
    run is bit-reproducible regardless of worker-thread interleaving;
    :meth:`FaultPlan.digest` is order-independent for the same reason.
    Transient injected errnos exercise the executor's bounded
    retry-with-backoff path exactly like real ones.

Wiring: ``controller.install(gsys)`` adds the policy to the shared
engine and attaches its stats to telemetry; ``gsys.use_fault_plan(plan)``
arms injection. The UDP server takes ``admission=`` and answers shed
requests with a ``SHED_TOKEN`` reply instead of queueing them.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.genesys.executor import EAGAIN, EINTR, EIO
from repro_torch.core.genesys.sched import Policy, QosReject
from repro_torch.core.genesys.trace import Counters

_ERRNO_NAMES = {"EIO": EIO, "EINTR": EINTR, "EAGAIN": EAGAIN}


class AdmitShed(QosReject):
    """Admission control shed this submission/request: nothing was
    queued; the caller should tell the client, not retry immediately."""


@dataclass(frozen=True)
class GroupSpec:
    """One admission group's declaration.

    ``slo_us``/``target`` declare a latency SLO over the controller's
    histogram (protected groups set one); ``priority_class`` is the shed
    rank: <= 0 is *protected* (never shed), higher ranks shed earlier
    and harder (shed fraction is proportional to rank). ``weight`` is
    advisory for the WFQ node the group's tenants share."""
    name: str
    slo_us: float | None = None
    target: float = 0.999
    priority_class: int = 0
    weight: float = 1.0


@dataclass
class AdmitStats:
    admitted: int = 0           # requests/submissions allowed through
    degraded: int = 0           # admitted with a degrade hint (shed_frac>0)
    shed: int = 0               # refused outright
    refreshes: int = 0          # controller refresh (tick+AIMD) rounds
    shed_level: float = 0.0     # current AIMD level in [0,1] (gauge)
    per_group: dict = field(default_factory=dict)   # name -> decision counts


class AdmissionController(Policy):
    """SLO-driven admit/degrade/shed decisions at submit time.

    Construct over a :class:`~repro_torch.core.genesys.metrics.MetricsRegistry`
    (usually ``gsys.metrics``), :meth:`declare` the groups, route request
    latencies in via :meth:`observe` (the serving loop's wall histogram
    does this for free when ``hist`` matches), and the controller keeps
    one shed level that protected-group SLO pressure raises and quiet
    periods decay. Decisions come two ways:

      * :meth:`admit_request` — request-grain, for the serving front end
        (returns ``"admit" | "degrade" | "shed"``);
      * the :class:`~repro_torch.core.genesys.sched.Policy` ``on_submit`` hook —
        call-grain, for tenants whose group is declared (sheds raise
        :class:`AdmitShed`, degrades pay a small throttle delay).
    """

    def __init__(self, registry, *, hist: str = "genesys_request_wall_us",
                 span: int = 8, raise_burn: float = 1.0,
                 relax_burn: float = 0.5, step: float = 0.2,
                 degrade_delay_s: float = 0.0005,
                 min_interval_s: float = 0.05):
        self.registry = registry
        self.hist = str(hist)
        self.span = max(1, int(span))
        self.raise_burn = float(raise_burn)
        self.relax_burn = float(relax_burn)
        self.step = float(step)
        self.degrade_delay_s = float(degrade_delay_s)
        self.min_interval_s = float(min_interval_s)
        self.counters = Counters(AdmitStats())
        self.stats = self.counters.stats
        self._lock = threading.Lock()
        self._specs: dict[str, GroupSpec] = {}
        self._assign: dict[str, str] = {}      # client/tenant -> group
        self._map_fn = None
        self._shed_frac: dict[str, float] = {}
        self._counts: dict[str, int] = {}      # per-group thinning counters
        self._level = 0.0
        self._last_refresh = -1e9

    # -- declarations ---------------------------------------------------------
    def declare(self, name: str, *, slo_us: float | None = None,
                target: float = 0.999, priority_class: int = 0,
                weight: float = 1.0) -> GroupSpec:
        """Declare (or redeclare) an admission group. Protected groups
        (``slo_us`` set, rank <= 0) get a per-group labeled SLO on the
        controller's histogram, so burn-rate gauges appear on the next
        registry tick."""
        spec = GroupSpec(str(name), None if slo_us is None else float(slo_us),
                         float(target), int(priority_class), float(weight))
        with self._lock:
            self._specs[spec.name] = spec
            self._shed_frac.setdefault(spec.name, 0.0)
        if spec.slo_us is not None:
            self.registry.set_slo(self.hist, spec.slo_us, target=spec.target,
                                  window=self.span, tenant=spec.name)
            # materialize the series now, so the burn gauge exists (at 0)
            # from the first tick even before any observation lands
            self.registry.histogram(self.hist, tenant=spec.name)
        return spec

    def assign(self, member, group: str) -> None:
        """Bind a tenant (sets ``tenant.group``, making it share the
        group's WFQ node) or a client id to a declared group."""
        group = str(group)
        if hasattr(member, "ring"):            # a Tenant
            member.group = group
            with self._lock:
                self._assign[member.name] = group
        else:
            with self._lock:
                self._assign[str(member)] = group

    def map_default(self, fn) -> None:
        """``fn(client_id) -> group name`` for clients without an explicit
        :meth:`assign` binding (e.g. hash 1k clients into 8 groups)."""
        self._map_fn = fn

    def group_of(self, client) -> str:
        client = str(client)
        with self._lock:
            g = self._assign.get(client)
        if g is not None:
            return g
        if self._map_fn is not None:
            return str(self._map_fn(client))
        return client

    @property
    def level(self) -> float:
        with self._lock:
            return self._level

    def shed_fracs(self) -> dict[str, float]:
        with self._lock:
            return dict(self._shed_frac)

    # -- the control loop -----------------------------------------------------
    def refresh(self, now: float | None = None, force: bool = False) -> float:
        """Rate-limited: tick the registry, read protected groups' burn
        rates + windowed p99s, AIMD the shed level, recompute per-group
        shed fractions. Returns the level. Called from every decision
        point, so no dedicated control thread is needed."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh < self.min_interval_s:
                return self._level
            self._last_refresh = now
            protected = [s for s in self._specs.values()
                         if s.slo_us is not None and s.priority_class <= 0]
        self.registry.tick(now=now)
        pressure = 0.0
        for spec in protected:
            burn = self.registry.gauge("genesys_slo_burn_rate",
                                       slo=self.hist,
                                       tenant=spec.name).value
            p99 = self.registry.quantile(self.hist, 0.99, span=self.span,
                                         tenant=spec.name)
            pressure = max(pressure, burn, p99 / spec.slo_us)
        with self._lock:
            if pressure > self.raise_burn:
                self._level = min(1.0,
                                  self._level + self.step * min(pressure, 3.0))
            elif pressure < self.relax_burn:
                self._level = max(0.0, self._level - self.step * 0.5)
            level = self._level
            specs = list(self._specs.values())
            max_rank = max((s.priority_class for s in specs
                            if s.priority_class > 0), default=1)
            for s in specs:
                if s.priority_class <= 0:
                    frac = 0.0
                else:
                    frac = min(1.0, level * s.priority_class / max_rank)
                self._shed_frac[s.name] = frac
            fracs = dict(self._shed_frac)
        for name, frac in fracs.items():
            self.registry.set("genesys_admit_shed_frac", frac, group=name)

        def _acct(s, level=level):
            s.refreshes += 1
            s.shed_level = level
        self.counters.update(_acct)
        return level

    # -- decisions ------------------------------------------------------------
    def _thin(self, group: str) -> str:
        """Deterministic proportional thinning: admit the n-th request of
        a group shedding fraction ``f`` iff the integer part of
        ``n * (1 - f)`` advanced — an exact ``1-f`` duty cycle with no
        PRNG, so a fixed schedule sheds a fixed pattern."""
        with self._lock:
            frac = self._shed_frac.get(group, 0.0)
            if frac <= 0.0:
                return "admit"
            n = self._counts[group] = self._counts.get(group, 0) + 1
        keep = 1.0 - frac
        if keep > 0.0 and int(n * keep) > int((n - 1) * keep):
            return "degrade"
        return "shed"

    def _count(self, group: str, outcome: str) -> None:
        fld = {"admit": "admitted", "degrade": "degraded",
               "shed": "shed"}[outcome]

        def _f(s):
            setattr(s, fld, getattr(s, fld) + 1)
            g = s.per_group.setdefault(
                group, {"admitted": 0, "degraded": 0, "shed": 0})
            g[fld] += 1
        self.counters.update(_f)

    def admit_request(self, client) -> str:
        """Request-grain decision for the serving front end. ``"shed"``
        means reply-and-drop now; ``"degrade"`` means serve with a
        reduced budget; ``"admit"`` is the fast path."""
        self.refresh()
        group = self.group_of(client)
        with self._lock:
            declared = group in self._specs
        if not declared:
            self.counters.add(admitted=1)
            return "admit"
        d = self._thin(group)
        self._count(group, d)
        return d

    def observe(self, client, wall_us: float) -> None:
        """Feed one finished request's wall latency (µs) into the
        group's histogram series — the burn-rate/quantile input."""
        self.registry.observe(self.hist, float(wall_us),
                              tenant=self.group_of(client))

    # -- Policy hooks (call-grain, for declared tenant groups) ----------------
    def on_submit(self, tenant, calls):
        group = getattr(tenant, "group", None) or tenant.name
        with self._lock:
            declared = group in self._specs
        if not declared:
            return None                 # no opinion on undeclared tenants
        self.refresh()
        d = self._thin(group)
        self._count(group, d)
        if d == "shed":
            raise AdmitShed(
                f"admission: group {group!r} shedding "
                f"{self._shed_frac.get(group, 0.0):.0%} at level "
                f"{self.level:.2f}")
        if d == "degrade":
            return self.degrade_delay_s or None
        return None

    def note_pressure(self) -> None:
        """Leading capacity signal (e.g. the continuous engine failed an
        admit for want of slots/blocks): nudge the level up without
        waiting for SLO burn to confirm the overload."""
        with self._lock:
            self._level = min(1.0, self._level + self.step * 0.5)

    def install(self, gsys) -> "AdmissionController":
        """Attach to a :class:`Genesys`: policy on the shared engine +
        stats into ``telemetry()["serving"]["admit"]``."""
        gsys.use_policies(self)
        gsys.attach_stats("admit", self.counters)
        return self


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

class _Rule:
    __slots__ = ("tenant", "sysno", "errnos", "rate_ppm", "count", "skip")

    def __init__(self, tenant, sysno, errnos, rate_ppm, count, skip):
        self.tenant = tenant            # None = any
        self.sysno = sysno              # None = any
        self.errnos = errnos
        self.rate_ppm = rate_ppm
        self.count = count              # max injections per (rule, key)
        self.skip = skip                # clean calls per key before arming


class FaultPlan:
    """Seeded deterministic errno schedules, checked per dispatch.

    :meth:`check` is called by :meth:`Executor.dispatch_call` with the
    submitting tenant's name (``None`` for the global ring / doorbell)
    and the sysno; it returns 0 (clean) or a positive errno to inject.
    The verdict for the n-th check of a ``(tenant, sysno)`` key is a
    keyed blake2b hash of ``(seed, tenant, sysno, n, rule)`` — per-key
    call indices are assigned and judged under one lock, so the schedule
    is bit-reproducible across runs and worker-thread interleavings
    (``PYTHONHASHSEED`` never enters the picture). :meth:`digest` hashes
    the sorted event log, so equal injection *sets* compare equal even
    when threads interleave the arrivals differently.
    """

    MAX_EVENTS = 1 << 16

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rules: list[_Rule] = []
        self._lock = threading.Lock()
        self._counts: dict[tuple, int] = {}        # (owner, sysno) -> checks
        self._hits: dict[tuple, int] = {}          # (rule_i, key) -> injects
        self._events: list[tuple] = []             # (owner, sysno, n, errno)
        self.checks = 0
        self.injected = 0
        self.dropped_events = 0

    def inject(self, *, tenant: str | None = None, sysno: int | None = None,
               errnos=(EIO,), rate: float = 1.0, count: int | None = None,
               skip: int = 0) -> "FaultPlan":
        """Add a rule: inject one of ``errnos`` into matching dispatches
        with probability ``rate`` (deterministically thinned), at most
        ``count`` times per (tenant, sysno) key, after ``skip`` clean
        calls per key. Returns self for chaining."""
        errnos = tuple(int(e) for e in errnos)
        if not errnos or any(e <= 0 for e in errnos):
            raise ValueError("errnos must be positive ints")
        if not (0.0 <= rate <= 1.0):
            raise ValueError("rate must be in [0, 1]")
        with self._lock:
            self._rules.append(_Rule(
                None if tenant is None else str(tenant),
                None if sysno is None else int(sysno),
                errnos, int(rate * 1_000_000),
                None if count is None else int(count), int(skip)))
        return self

    def _verdict(self, owner: str, sysno: int, n: int, rule_i: int) -> int:
        h = hashlib.blake2b(
            f"{self.seed}:{owner}:{sysno}:{n}:{rule_i}".encode(),
            digest_size=8)
        return int.from_bytes(h.digest(), "little")

    def check(self, owner, sysno: int) -> int:
        """0 = dispatch normally; a positive errno = inject ``-errno``."""
        owner = "" if owner is None else str(owner)
        sysno = int(sysno)
        with self._lock:
            key = (owner, sysno)
            n = self._counts.get(key, 0)
            self._counts[key] = n + 1
            self.checks += 1
            for i, r in enumerate(self._rules):
                if r.tenant is not None and r.tenant != owner:
                    continue
                if r.sysno is not None and r.sysno != sysno:
                    continue
                if n < r.skip:
                    continue
                u = self._verdict(owner, sysno, n, i)
                if (u % 1_000_000) >= r.rate_ppm:
                    continue
                if r.count is not None:
                    # per-key call indices are judged in increasing-n order
                    # under this lock, so the first `count` matches are the
                    # same n values every run
                    hits = self._hits.get((i, key), 0)
                    if hits >= r.count:
                        continue
                    self._hits[(i, key)] = hits + 1
                e = r.errnos[(u >> 32) % len(r.errnos)]
                self.injected += 1
                if len(self._events) < self.MAX_EVENTS:
                    self._events.append((owner, sysno, n, e))
                else:
                    self.dropped_events += 1
                return e
        return 0

    def events(self) -> list[tuple]:
        with self._lock:
            return list(self._events)

    def digest(self) -> str:
        """Order-independent fingerprint of every injected fault — equal
        across two runs of the same seeded schedule (the fig14 part-B
        reproducibility gate)."""
        with self._lock:
            ev = sorted(self._events)
            dropped = self.dropped_events
        h = hashlib.blake2b(digest_size=16)
        for owner, sysno, n, e in ev:
            h.update(f"{owner}:{sysno}:{n}:{e};".encode())
        h.update(f"dropped={dropped}".encode())
        return h.hexdigest()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from the ``--fault-plan`` CLI grammar:
        ``SEED[;TENANT:SYSNO:ERRNO:RATE]...`` where TENANT/SYSNO may be
        ``*`` (any) and ERRNO is a name (EIO/EAGAIN/EINTR) or an int —
        e.g. ``42;*:17:EIO:0.05;flood:45:EAGAIN:1.0``."""
        parts = [p for p in str(spec).split(";") if p]
        if not parts:
            raise ValueError("empty fault plan")
        plan = cls(seed=int(parts[0]))
        for p in parts[1:]:
            fields = p.split(":")
            if len(fields) != 4:
                raise ValueError(
                    f"rule {p!r} is not TENANT:SYSNO:ERRNO:RATE")
            tenant, sysno, errno_s, rate = fields
            e = _ERRNO_NAMES.get(errno_s.upper())
            plan.inject(
                tenant=None if tenant == "*" else tenant,
                sysno=None if sysno == "*" else int(sysno),
                errnos=(int(errno_s) if e is None else e,),
                rate=float(rate))
        return plan

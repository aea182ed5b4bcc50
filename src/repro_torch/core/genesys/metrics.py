"""genesys.metrics — windowed time-series metrics + Prometheus exposition.

`genesys.trace` answers "what happened per call"; this registry answers
"what is happening *over time*": every metric is a named, labeled series
whose current value lives in one slot of a shared numpy array, and
:meth:`MetricsRegistry.tick` snapshots ALL of them into a fixed-capacity
ring of windows (`EventRing` discipline: preallocated arrays, wraparound
write position, vectorized whole-array copies — no per-series Python on
the snapshot path, no per-call Python beyond one locked array store on
the hot path).

Three metric kinds:

* **counter** — monotone cumulative count. Mirrored counters (from
  ``Genesys.telemetry()``) are *set* to the upstream cumulative value by
  a collector at tick time; locally owned counters are incremented.
  Windowed **rates** come from diffing the cumulative value across
  window snapshots, so a wrapped window ring never under- or
  over-counts the interval it still covers.
* **gauge** — last-write-wins instantaneous value (queue depth, slot
  occupancy, burn rate).
* **histogram** — log2 µs buckets (``trace.bucket_of`` layout: bucket
  ``b`` covers ``(2^(b-1), 2^b]`` µs). Stored cumulative; windowed
  quantiles diff bucket counts between snapshots, so ``quantile(span=k)``
  is the p-quantile of the LAST k windows only — the per-tenant windowed
  p99 series the ROADMAP's SLO-admission item consumes.

**SLO burn rates**: :meth:`MetricsRegistry.set_slo` declares a latency
SLO over a histogram name; every tick derives, per matching series, the
fraction of recent observations over the SLO divided by the error budget
``1 - target`` — the standard multi-window burn-rate signal (burn > 1
means the budget is being spent faster than it accrues) — into
``genesys_slo_burn_rate`` gauges.

**Exposition**: :meth:`MetricsRegistry.prometheus_text` renders the
Prometheus text format (0.0.4): ``# HELP``/``# TYPE`` headers, labeled
samples, cumulative ``_bucket{le=...}`` + ``_sum``/``_count`` for
histograms. Served two ways: the UDP METRICS op on the serving socket
(``serving.server.METRICS_MAGIC``) and :class:`MetricsHttpServer` — a
dependency-free TCP endpoint (``GET /metrics`` scrapes, ``GET
/telemetry`` returns the full JSON snapshot with no datagram ceiling)
wired up by ``launch/serve --metrics-port``.

:func:`install_genesys_collector` bridges the two observability layers:
a tick-time collector pulls one ``Genesys.telemetry()`` snapshot and
mirrors totals, per-sysno and per-tenant counters, trace-derived p99
gauges, and every ``Genesys.attach_stats`` serving source into the
registry under stable Prometheus names.
"""
from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np

from repro_torch.core.genesys.trace import bucket_of, jsonable

N_BUCKETS = 40            # log2 µs buckets: 2^39 µs ~ 6.4 days, plenty

_COUNTER = 0
_GAUGE = 1


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in labels) + "}"


class Counter:
    """Handle to one cumulative counter series (hot path: one locked
    float64 store)."""
    __slots__ = ("_reg", "idx")

    def __init__(self, reg: "MetricsRegistry", idx: int):
        self._reg, self.idx = reg, idx

    def inc(self, n: float = 1) -> None:
        self._reg._add_idx(self.idx, n)

    @property
    def value(self) -> float:
        return self._reg._get_idx(self.idx)


class Gauge:
    """Handle to one instantaneous-value series."""
    __slots__ = ("_reg", "idx")

    def __init__(self, reg: "MetricsRegistry", idx: int):
        self._reg, self.idx = reg, idx

    def set(self, v: float) -> None:
        self._reg._set_idx(self.idx, v)

    def inc(self, n: float = 1) -> None:
        self._reg._add_idx(self.idx, n)

    @property
    def value(self) -> float:
        return self._reg._get_idx(self.idx)


class Histogram:
    """Handle to one log2-bucket latency histogram series."""
    __slots__ = ("_reg", "idx")

    def __init__(self, reg: "MetricsRegistry", idx: int):
        self._reg, self.idx = reg, idx

    def observe(self, us: float) -> None:
        self._reg._observe_idx(self.idx, us)

    def observe_block(self, us) -> None:
        """Record a whole array of µs samples in one locked vectorized
        update (bincount over bucket indices) — the block-grain hot path."""
        self._reg._observe_block_idx(self.idx, us)


class MetricsRegistry:
    """Fixed-window time-series registry (see module docstring).

    ``n_windows`` bounds history: ``tick()`` number ``n_windows + 1``
    overwrites the oldest snapshot, so rates/quantiles degrade to the
    covered span — never to wrong values.
    """

    def __init__(self, n_windows: int = 120):
        if n_windows < 2:
            raise ValueError("need at least 2 windows for rates")
        self.n_windows = int(n_windows)
        self._lock = threading.Lock()
        # scalar series (counters + gauges), index-addressed
        self._idx: dict[tuple, int] = {}
        self._meta: list[tuple[str, tuple, int]] = []  # (name, labels, kind)
        self._vals = np.zeros(64, np.float64)
        self._wvals = np.zeros((self.n_windows, 64), np.float64)
        self._n = 0
        # histogram series
        self._hidx: dict[tuple, int] = {}
        self._hmeta: list[tuple[str, tuple]] = []
        self._hb = np.zeros((16, N_BUCKETS), np.int64)
        self._hsum = np.zeros(16, np.float64)
        self._whb = np.zeros((self.n_windows, 16, N_BUCKETS), np.int64)
        self._whsum = np.zeros((self.n_windows, 16), np.float64)
        self._hn = 0
        # window ring bookkeeping
        self._wts = np.zeros(self.n_windows, np.float64)
        self._wn = 0                      # ticks so far (monotone)
        self._help: dict[str, str] = {}
        self._collectors: list = []
        # SLO declarations keyed (histogram name, labels_key): labeled
        # declarations bind one series; a label-less declaration is the
        # catch-all for every series of that name without its own entry
        self._slos: dict[tuple[str, tuple], tuple[float, float, int]] = {}

    # ------------------------------------------------- series management ----
    def _series(self, name: str, labels: dict, kind: int,
                help_: str = "") -> int:
        key = (name,) + _labels_key(labels)
        with self._lock:
            i = self._idx.get(key)
            if i is not None:
                return i
            if self._n == len(self._vals):
                self._vals = np.concatenate(
                    [self._vals, np.zeros_like(self._vals)])
                self._wvals = np.concatenate(
                    [self._wvals, np.zeros_like(self._wvals)], axis=1)
            i = self._n
            self._n += 1
            self._idx[key] = i
            self._meta.append((name, _labels_key(labels), kind))
            if help_ and name not in self._help:
                self._help[name] = help_
            return i

    def _hseries(self, name: str, labels: dict, help_: str = "") -> int:
        key = (name,) + _labels_key(labels)
        with self._lock:
            i = self._hidx.get(key)
            if i is not None:
                return i
            if self._hn == len(self._hb):
                self._hb = np.concatenate(
                    [self._hb, np.zeros_like(self._hb)])
                self._hsum = np.concatenate(
                    [self._hsum, np.zeros_like(self._hsum)])
                self._whb = np.concatenate(
                    [self._whb, np.zeros_like(self._whb)], axis=1)
                self._whsum = np.concatenate(
                    [self._whsum, np.zeros_like(self._whsum)], axis=1)
            i = self._hn
            self._hn += 1
            self._hidx[key] = i
            self._hmeta.append((name, _labels_key(labels)))
            if help_ and name not in self._help:
                self._help[name] = help_
            return i

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return Counter(self, self._series(name, labels, _COUNTER, help))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return Gauge(self, self._series(name, labels, _GAUGE, help))

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return Histogram(self, self._hseries(name, labels, help))

    # --------------------------------------------------------- hot paths ----
    def _add_idx(self, i: int, n: float) -> None:
        with self._lock:
            self._vals[i] += n

    def _set_idx(self, i: int, v: float) -> None:
        with self._lock:
            self._vals[i] = v

    def _get_idx(self, i: int) -> float:
        with self._lock:
            return float(self._vals[i])

    def _observe_idx(self, i: int, us: float) -> None:
        b = min(N_BUCKETS - 1, bucket_of(us))
        with self._lock:
            self._hb[i, b] += 1
            self._hsum[i] += us

    def _observe_block_idx(self, i: int, us) -> None:
        arr = np.asarray(us, np.float64).ravel()
        if not arr.size:
            return
        b = np.zeros(arr.size, np.int64)
        pos = arr > 1.0
        b[pos] = np.ceil(np.log2(arr[pos])).astype(np.int64)
        np.clip(b, 0, N_BUCKETS - 1, out=b)
        add = np.bincount(b, minlength=N_BUCKETS)
        s = float(arr.sum())
        with self._lock:
            self._hb[i] += add
            self._hsum[i] += s

    # -------------------------------------------- name-addressed facade ----
    def inc(self, name: str, n: float = 1, **labels) -> None:
        self._add_idx(self._series(name, labels, _COUNTER), n)

    def set(self, name: str, value: float, kind: str = "gauge",
            **labels) -> None:
        """Set a series' current value. ``kind="counter"`` marks the
        series monotone-cumulative (the collector idiom: mirror an
        upstream counter's absolute value; rates still work because they
        diff snapshots, not increments)."""
        k = _COUNTER if kind == "counter" else _GAUGE
        self._set_idx(self._series(name, labels, k), value)

    def observe(self, name: str, us: float, **labels) -> None:
        self._observe_idx(self._hseries(name, labels), us)

    def register_collector(self, fn) -> None:
        """``fn()`` runs at the top of every :meth:`tick`, outside the
        registry lock — it is expected to call ``set``/``inc``/``observe``."""
        with self._lock:
            self._collectors.append(fn)

    # ------------------------------------------------------------ windows ---
    def tick(self, now: float | None = None) -> None:
        """Run collectors, then snapshot every series into the window
        ring (one vectorized copy per array), then refresh derived SLO
        burn-rate gauges."""
        for fn in list(self._collectors):
            fn()
        if now is None:
            now = time.monotonic()
        with self._lock:
            p = self._wn % self.n_windows
            self._wvals[p, :] = self._vals
            self._whb[p, :, :] = self._hb
            self._whsum[p, :] = self._hsum
            self._wts[p] = now
            self._wn += 1
        for name, labels, burn in self._burn_rates_list():
            self.set("genesys_slo_burn_rate", burn, slo=name,
                     **dict(labels))

    def _avail(self) -> int:
        return min(self._wn, self.n_windows)

    def rate(self, name: str, span: int = 1, **labels) -> float:
        """Per-second rate of a (counter) series over the last ``span``
        window intervals (clamped to available history)."""
        key = (name,) + _labels_key(labels)
        with self._lock:
            i = self._idx.get(key)
            avail = self._avail()
            if i is None or avail < 2:
                return 0.0
            span = max(1, min(int(span), avail - 1))
            a = (self._wn - 1) % self.n_windows
            b = (self._wn - 1 - span) % self.n_windows
            dt = self._wts[a] - self._wts[b]
            if dt <= 0:
                return 0.0
            return float(self._wvals[a, i] - self._wvals[b, i]) / dt

    def _hdelta_locked(self, i: int, span: int | None) -> np.ndarray:
        """Live cumulative buckets minus the snapshot ``span`` ticks ago
        (lock held). ``span=None`` → all-time."""
        d = self._hb[i].astype(np.float64).copy()
        if span is not None:
            avail = self._avail()
            if avail:
                s = max(1, min(int(span), avail))
                d -= self._whb[(self._wn - s) % self.n_windows, i]
        return d

    @staticmethod
    def _bucket_quantile(d: np.ndarray, q: float) -> float:
        n = d.sum()
        if n <= 0:
            return 0.0
        b = int(np.searchsorted(np.cumsum(d), q * n))
        return float(2.0 ** min(b, N_BUCKETS - 1))

    def quantile(self, name: str, q: float = 0.99,
                 span: int | None = None, **labels) -> float:
        """Windowed quantile (µs, log2-bucket upper edge) of a histogram
        series: observations since the snapshot ``span`` ticks ago
        (``span=None`` → everything recorded)."""
        key = (name,) + _labels_key(labels)
        with self._lock:
            i = self._hidx.get(key)
            if i is None:
                return 0.0
            d = self._hdelta_locked(i, span)
        return self._bucket_quantile(d, q)

    def quantile_series(self, name: str, q: float = 0.99,
                        **labels) -> list[float]:
        """Per-window quantile series (oldest → newest): the quantile of
        each window interval's own observations. When the ring has
        wrapped, the oldest available snapshot only serves as a baseline
        (its own interval's predecessor is gone)."""
        key = (name,) + _labels_key(labels)
        with self._lock:
            i = self._hidx.get(key)
            if i is None:
                return []
            avail = self._avail()
            wrapped = self._wn > self.n_windows
            snaps = [self._whb[(self._wn - j) % self.n_windows, i].astype(
                np.float64) for j in range(avail, 0, -1)]
        out: list[float] = []
        prev = None if wrapped else np.zeros(N_BUCKETS)
        for cur in snaps:
            if prev is not None:
                out.append(self._bucket_quantile(cur - prev, q))
            prev = cur
        return out

    # ---------------------------------------------------------- SLO burn ----
    def set_slo(self, name: str, slo_us: float, *, target: float = 0.999,
                window: int = 12, **labels) -> None:
        """Declare a latency SLO over histogram ``name``: ``target``
        fraction of observations must land <= ``slo_us``. Every tick
        derives a ``genesys_slo_burn_rate{slo=name, ...}`` gauge per
        matching series over the last ``window`` window intervals.
        With ``**labels`` the SLO binds only the exactly-matching series
        (the per-tenant-group idiom admission control uses); a label-less
        declaration remains the catch-all for every series of the name
        that has no labeled declaration of its own."""
        if not (0.0 < target < 1.0):
            raise ValueError("target must be in (0, 1)")
        with self._lock:
            self._slos[(name, _labels_key(labels))] = (
                float(slo_us), float(target), int(window))

    def _burn_rates_list(self) -> list[tuple[str, tuple, float]]:
        out: list[tuple[str, tuple, float]] = []
        with self._lock:
            slos = dict(self._slos)
            series = []
            for i, (name, labels) in enumerate(self._hmeta):
                slo = slos.get((name, labels)) or slos.get((name, ()))
                if slo is not None:
                    series.append((i, name, labels, slo))
            deltas = {i: self._hdelta_locked(i, slo[2])
                      for i, name, labels, slo in series}
        for i, name, labels, (slo_us, target, _) in series:
            d = deltas[i]
            n = d.sum()
            over = d[min(N_BUCKETS, bucket_of(slo_us) + 1):].sum()
            frac = float(over) / float(n) if n > 0 else 0.0
            out.append((name, labels,
                        float(frac / max(1e-9, 1.0 - target))))
        return out

    def burn_rates(self) -> dict[str, float]:
        """Current SLO burn rates, keyed ``name{labels}``; burn > 1 means
        the error budget is being spent faster than it accrues."""
        return {f"{name}{_label_str(labels)}": burn
                for name, labels, burn in self._burn_rates_list()}

    # --------------------------------------------------------- exposition ---
    def prometheus_text(self) -> str:
        """Render every series in the Prometheus text format (0.0.4)."""
        with self._lock:
            vals = self._vals[:self._n].copy()
            meta = list(self._meta)
            hb = self._hb[:self._hn].copy()
            hsum = self._hsum[:self._hn].copy()
            hmeta = list(self._hmeta)
            helps = dict(self._help)
        lines: list[str] = []
        seen_type: set[str] = set()

        def header(name: str, kind: str) -> None:
            if name in seen_type:
                return
            seen_type.add(name)
            h = helps.get(name)
            if h:
                lines.append(f"# HELP {name} {_escape(h)}")
            lines.append(f"# TYPE {name} {kind}")

        for i, (name, labels, kind) in enumerate(meta):
            header(name, "counter" if kind == _COUNTER else "gauge")
            lines.append(f"{name}{_label_str(labels)} {_fmt(vals[i])}")
        for i, (name, labels) in enumerate(hmeta):
            header(name, "histogram")
            total = int(hb[i].sum())
            hi = int(np.max(np.nonzero(hb[i])[0], initial=7)) + 1
            cum = 0
            for b in range(min(hi + 1, N_BUCKETS)):
                cum += int(hb[i, b])
                le = _label_str(labels + (("le", _fmt(2.0 ** b)),))
                lines.append(f"{name}_bucket{le} {cum}")
            inf = _label_str(labels + (("le", "+Inf"),))
            lines.append(f"{name}_bucket{inf} {total}")
            lines.append(f"{name}_sum{_label_str(labels)} {_fmt(hsum[i])}")
            lines.append(f"{name}_count{_label_str(labels)} {total}")
        return "\n".join(lines) + "\n"


class MetricsHttpServer:
    """Dependency-free TCP exposition endpoint (daemon accept thread).

    Routes: ``GET /metrics`` ticks the registry and returns the
    Prometheus text; ``GET /telemetry`` (when ``telemetry_fn`` is given)
    returns the full JSON snapshot — satellite of the UDP STATS op's
    datagram ceiling: over TCP the payload is never truncated.
    ``port=0`` binds an ephemeral port, published as :attr:`port`.
    """

    def __init__(self, registry: MetricsRegistry, *, port: int = 0,
                 host: str = "127.0.0.1", telemetry_fn=None):
        self.registry = registry
        self.telemetry_fn = telemetry_fn
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._closing = False
        self._thread = threading.Thread(
            target=self._serve, daemon=True, name="genesys-metrics-http")
        self._thread.start()

    def _serve(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return                  # listener closed
            try:
                self._handle(conn)
            except OSError:
                pass                    # client went away mid-reply
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _handle(self, conn: socket.socket) -> None:
        conn.settimeout(2.0)
        data = b""
        while (b"\r\n\r\n" not in data and b"\n\n" not in data
               and len(data) < 65536):
            chunk = conn.recv(4096)
            if not chunk:
                break
            data += chunk
        first = data.split(b"\r\n", 1)[0].split(b"\n", 1)[0]
        parts = first.decode("latin-1", "replace").split()
        path = parts[1] if len(parts) >= 2 else "/"
        if path.split("?", 1)[0] == "/metrics":
            self.registry.tick()
            body = self.registry.prometheus_text().encode()
            status, ctype = "200 OK", "text/plain; version=0.0.4"
        elif (path.split("?", 1)[0] == "/telemetry"
              and self.telemetry_fn is not None):
            body = json.dumps(jsonable(self.telemetry_fn())).encode()
            status, ctype = "200 OK", "application/json"
        else:
            body = b"not found\n"
            status, ctype = "404 Not Found", "text/plain"
        head = (f"HTTP/1.0 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
        conn.sendall(head.encode() + body)

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


# fields that are levels, not cumulative counts, in serving snapshots
_GAUGE_FIELDS = {"queue_depth", "queue_depth_peak", "blocks_in_use",
                 "peak_blocks_in_use", "wall_s", "spill_live_bytes",
                 "shed_level"}


def install_genesys_collector(registry: MetricsRegistry, gsys) -> None:
    """Register a tick-time collector mirroring one
    ``Genesys.telemetry()`` snapshot into stable Prometheus series (see
    module docstring). Installed automatically by ``Genesys.metrics``."""

    def collect() -> None:
        t = gsys.telemetry()
        tot = t.get("totals") or {}
        for f in ("submitted", "completed", "reaped"):
            registry.set(f"genesys_{f}_total", tot.get(f, 0), kind="counter")
        ex = t.get("executor") or {}
        registry.set("genesys_interrupts_total", ex.get("interrupts", 0),
                     kind="counter")
        for sysname, n in (t.get("syscalls") or {}).items():
            registry.set("genesys_syscalls_total", n, kind="counter",
                         sysno=str(sysname))
        ring = t.get("ring") or {}
        registry.set("genesys_ring_fallbacks_total",
                     ring.get("fallback_doorbell", 0), kind="counter")
        for tname, rec in (t.get("tenants") or {}).items():
            st = rec.get("stats") or {}
            for f in ("submitted", "reaped", "throttled", "rejected"):
                if f in st:
                    registry.set(f"genesys_tenant_{f}_total", st[f],
                                 kind="counter", tenant=tname)
        for cname, per_sys in (t.get("histograms") or {}).items():
            for sname, stages in per_sys.items():
                st = (stages.get("total") or stages.get("irq_total")
                      or stages.get("request"))
                if st:
                    registry.set("genesys_syscall_p99_us", st["p99_us"],
                                 tenant=cname, sysno=sname)
        srv = t.get("serving") or {}
        for src, snap in srv.items():
            for f, v in snap.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if f in _GAUGE_FIELDS:
                    registry.set(f"genesys_{src}_{f}", v)
                else:
                    registry.set(f"genesys_{src}_{f}_total", v,
                                 kind="counter")
        eng = srv.get("engine")
        if eng and eng.get("steps"):
            registry.set("genesys_engine_occupancy",
                         eng["step_slots"] / max(1, eng["steps"]))
        pk = srv.get("pagedkv")
        if pk and pk.get("prefix_queries"):
            registry.set("genesys_pagedkv_prefix_hit_rate",
                         pk["prefix_hits"] / max(1, pk["prefix_queries"]))
        cp = t.get("copies") or {}
        for path in ("resolve", "scatter", "gather", "reply", "register"):
            registry.set("genesys_bytes_copied_total", cp.get(path, 0),
                         kind="counter", path=path)
        for tname, nb in (cp.get("per_tenant") or {}).items():
            registry.set("genesys_tenant_bytes_copied_total", nb,
                         kind="counter", tenant=str(tname))

    registry.register_collector(collect)

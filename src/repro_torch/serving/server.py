"""Batched UDP token-serving loop — the paper's echo server (§7.3)
generalized: requests arrive as UDP packets, are batched, run through the
model's serve_step, and answered with sendto.

Two paths, mirroring the paper's comparison:
  * GENESYS path: recvfrom/sendto are GENESYS syscalls at work-group
    granularity with blocking + weak ordering (the paper's exact choice for
    its echo server);
  * CPU baseline: a classic host loop that owns the socket and babysits the
    accelerator (Fig 1 left).

``use_ring=True`` swaps the doorbell-interrupt syscall path for the
genesys.uring rings: receives are ring calls (Completion-future blocking),
and each reply batch goes out as ONE multi-entry submission whose sends
complete asynchronously — drain() is the only barrier.

``use_tenants=True`` (implies the ring path) runs the server on
genesys.sched per-tenant rings: receives go through a high-priority
``serve-rx`` tenant, and reply traffic is hash-sharded onto a bounded
pool of ``client-shard:<i>`` tenants (``tx_shards`` of them; the slot
area is finite, so per-port tenants cannot be unbounded), so one client
flooding its reply shard cannot starve receives or other shards'
replies — QoS policies installed via ``Genesys.use_policies`` (token
bucket, strict priority, WFQ) apply per shard.

``serve_model(..., batch_decode=True)`` batches the decode itself:
concurrent requests are bucketed to a power-of-two batch, each token
step is one ``serve_fn`` dispatch for the whole bucket, and the bucket's
replies fan out through the ring/tenant path as one multi-entry
submission.

This is the PyTorch port of ``repro.serving.server``: the reference's
text, with its JAX arrays as torch tensors on the cache's device. Two
differences: the port's serve steps update the dense cache in place, where
the reference's return a new one, so every request decodes on a copy of
the template cache (see :func:`_greedy_decode`); and a
:class:`GenesysUdpServer` whose BIND fails raises ``OSError``, where the
reference drops BIND's result and polls a socket that is bound to
nothing.
"""
from __future__ import annotations

import json
import os
import socket
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.genesys import Genesys, Sys
from repro_torch.core.genesys.trace import (
    EV_REQ_BEGIN, EV_REQ_END, REQ_SYSNO, Counters, jsonable, summary_dict,
)

# STATS request op: a datagram ``GSTATS1\0 + uint32 reply_port (LE)``
# is answered with the server's Genesys.telemetry() snapshot as JSON
# (the full snapshot when it fits a datagram, else the compact summary,
# flagged ``"truncated": true`` — the TCP /telemetry endpoint of
# metrics.MetricsHttpServer always carries the full payload) instead of
# entering the request batch.
STATS_MAGIC = b"GSTATS1\x00"
# METRICS request op: same wire shape, answered with the Prometheus text
# exposition of Genesys.metrics (ticked on demand, so a UDP scrape sees
# fresh windows); over-ceiling replies are cut at a line boundary and
# flagged with a trailing ``# truncated`` comment.
METRICS_MAGIC = b"GMETRX1\x00"
_STATS_MAX_DGRAM = 60000      # stay under the UDP payload ceiling

# admission-control shed reply: a one-token body ``[SHED_TOKEN]`` (after
# the echoed tag) tells an open-loop client its request was refused by
# load shedding — not lost, not failed — so it can back off or retry
# against a lower-rank class. Negative, so it can never collide with a
# real generated token id (vocab ids are non-negative).
SHED_TOKEN = -503


@dataclass
class ServeStats:
    requests: int = 0
    batches: int = 0
    tokens_out: int = 0
    wall_s: float = 0.0
    # decode accounting, consistent across ALL decode paths (fig12's
    # dispatch-amortization ratio is decode_steps / decode_dispatches):
    #   decode_dispatches — actual serve_fn invocations (jit dispatches)
    #   decode_steps      — per-request token steps those dispatches
    #                       covered (eager: == dispatches; batched/
    #                       continuous: n_active per dispatch)
    decode_dispatches: int = 0
    decode_steps: int = 0
    decode_buckets: int = 0      # batched-decode buckets run
    stats_requests: int = 0      # STATS/METRICS ops answered
    # continuous-loop admission pressure (queue_depth* are levels)
    queue_depth: int = 0         # parsed requests awaiting a slot
    queue_depth_peak: int = 0
    poll_skips: int = 0          # polls skipped: admission was impossible
    # genesys.admit decisions taken at the serving front end
    shed_requests: int = 0       # refused: answered [SHED_TOKEN], not queued
    degraded_requests: int = 0   # served with a halved token budget


class GenesysUdpServer:
    """Echo/decode server whose network I/O is GENESYS syscalls."""

    def __init__(self, gsys: Genesys, *, port: int, max_batch: int = 8,
                 batch_window_s: float = 0.005, payload: int = 4096,
                 use_ring: bool = False, use_tenants: bool = False,
                 tx_shards: int = 8, admission=None):
        self.gsys = gsys
        self.port = port
        self.max_batch = max_batch
        self.window = batch_window_s
        self.payload = payload
        # genesys.admit AdmissionController (or None): requests then carry
        # a client id word ([budget, tag, client, prompt...]) and shed
        # requests are answered with [SHED_TOKEN] instead of being queued
        self.admission = admission
        self.use_tenants = use_tenants
        self.use_ring = use_ring or use_tenants
        self.tx_shards = max(1, int(tx_shards))
        if use_tenants:
            # receive side: latency-critical tenant, reaped first under
            # StrictPriority and never stuck behind a client's reply flood
            self._rx = gsys.tenant("serve-rx", weight=8.0, priority=10)
            self._call = self._rx.call
            # reply side: the shard pool is built up front, so the per-
            # reply hot path is one list index — no Genesys.tenant() lock
            self._tx = [gsys.tenant(f"client-shard:{i}", n_slots=128)
                        for i in range(self.tx_shards)]
        else:
            self._rx = None
            self._tx = []
            self._call = gsys.ring_call if self.use_ring else gsys.call
        self.fd = self._call(Sys.SOCKET, socket.AF_INET, socket.SOCK_DGRAM, 0)
        rc = self._call(Sys.BIND, self.fd, port)
        if rc < 0:
            # an unbound socket would poll forever for requests that
            # cannot reach it: a port that is taken fails here, at once
            self._call(Sys.CLOSE, self.fd)
            raise OSError(-rc, f"GenesysUdpServer: BIND to port {port} "
                               f"failed: {os.strerror(-rc)}")
        sock = gsys.table._sockets[self.fd]
        sock.settimeout(0.2)
        # trace.Counters fold: serving stats join Genesys.telemetry()
        # ("serving"/"server") and stay torn-read-free for scrapers
        self.counters = Counters(ServeStats())
        gsys.attach_stats("server", self.counters)
        # per-request wall-time histogram (µs) in the metrics registry —
        # the windowed-p99 / SLO-burn input for the serving path
        self._wall_hist = gsys.metrics.histogram(
            "genesys_request_wall_us", "per-request serve wall time (µs)")
        self._pending_handles: list[int] = []
        # reusable receive staging: one arena extent per batch position,
        # carved ONCE — RECVFROM lands each datagram in place (zero-copy
        # under HostArena) and poll_requests returns borrowed views instead
        # of per-datagram new_buffer/copy/release (the UDP double-copy fix)
        self._rx_handles = [gsys.heap.new_buffer(payload)
                            for _ in range(max_batch)]
        self._rx_bufs = [np.asarray(gsys.heap.resolve(h))
                         for h in self._rx_handles]

    @property
    def stats(self) -> ServeStats:
        return self.counters.stats

    @stats.setter
    def stats(self, new) -> None:
        with self.counters.lock:
            self.counters.stats = new

    def poll_requests(self, idle_wait: float | None = None
                      ) -> list[np.ndarray]:
        """Gather up to max_batch datagrams within the batching window
        (blocking weak-ordered recvfrom syscalls). The first receive waits
        the idle timeout; follow-ups only wait the short batching window so
        a lone request is answered immediately. ``idle_wait`` overrides the
        first-receive wait — the continuous engine polls with a tiny wait
        while slots are decoding so admission never stalls the batch.

        Returned arrays are views of the server's staging extents, valid
        until the NEXT poll — every consumer (parse_request, reply,
        _maybe_stats) copies what it keeps within the same iteration."""
        out = []
        sock = self.gsys.table._sockets[self.fd]
        idle_timeout = sock.gettimeout()
        if idle_wait is not None:
            sock.settimeout(idle_wait)
        try:
            while len(out) < self.max_batch:
                i = len(out)        # control ops below don't consume a slot
                n = self._call(Sys.RECVFROM, self.fd, self._rx_handles[i],
                               self.payload)
                if n > 0:
                    req = self._rx_bufs[i][:n]
                    if self._maybe_stats(req):
                        continue      # control op, not a serving request
                    out.append(req)
                    sock.settimeout(self.window)
                if n <= 0:
                    break
        finally:
            try:
                sock.settimeout(idle_timeout)
            except OSError:
                pass   # socket closed during shutdown
        return out

    def _maybe_stats(self, req: np.ndarray) -> bool:
        """Handle a STATS or METRICS control datagram: reply with the
        telemetry JSON snapshot / Prometheus text to the embedded port.
        Returns True if ``req`` was a control op (and must not enter the
        request batch)."""
        data = req.tobytes()
        want_metrics = data.startswith(METRICS_MAGIC)
        if not want_metrics and not data.startswith(STATS_MAGIC):
            return False
        self.counters.add(stats_requests=1)
        if len(data) >= len(STATS_MAGIC) + 4:
            port = int.from_bytes(
                data[len(STATS_MAGIC):len(STATS_MAGIC) + 4], "little")
            if port:
                self.reply([self._metrics_blob() if want_metrics
                            else self._stats_blob()], port)
        return True

    def _stats_blob(self) -> bytes:
        snap = self.gsys.telemetry()
        blob = json.dumps(jsonable(snap)).encode()
        if len(blob) > _STATS_MAX_DGRAM:   # huge histogram set: the
            # summary fallback says so explicitly — the TCP /telemetry
            # endpoint serves the full payload with no ceiling
            s = summary_dict(snap)
            s["truncated"] = True
            blob = json.dumps(s).encode()
        return blob

    def _metrics_blob(self) -> bytes:
        reg = self.gsys.metrics
        reg.tick()
        text = reg.prometheus_text().encode()
        if len(text) > _STATS_MAX_DGRAM:
            cut = text.rfind(b"\n", 0, _STATS_MAX_DGRAM - 16)
            text = text[:max(0, cut)] + b"\n# truncated\n"
        return text

    # async sends hold their payload extents alive until a drain barrier;
    # past this many outstanding handles, reply() forces one so a long-
    # running server can't grow the pending list (and the arena) unboundedly
    PENDING_RELEASE_THRESHOLD = 1024

    def reply(self, payloads, port: int) -> None:
        """Send ``payloads`` (bytes or uint8 arrays) to ``port``. Each
        payload is staged ONCE into an arena extent (register_bytes, the
        "reply" copy path) and SENDTO transmits straight off the extent —
        no frombuffer().copy() + tobytes() round trip per send."""
        if self.use_ring:
            # ring fast path: the whole reply batch is one multi-entry
            # submission; sends complete out of band, drain() is the barrier
            calls = []
            for p in payloads:
                bh = self.gsys.heap.register_bytes(p, path="reply")
                self._pending_handles.append(bh)
                calls.append((Sys.SENDTO, self.fd, bh, len(p), port))
            if self.use_tenants:
                # per-client tenant, hash-sharded onto the bounded pool:
                # this port's sends ride their shard's ring, subject to
                # its rate limit / WFQ share (the slot area is finite, so
                # one tenant per port would exhaust it under churn)
                self._tx[port % self.tx_shards].submit(calls)
            else:
                self.gsys.ring_submit(calls)
            self._maybe_release_pending()
            return
        for p in payloads:
            bh = self.gsys.heap.register_bytes(p, path="reply")
            self.gsys.call(Sys.SENDTO, self.fd, bh, len(p), port,
                           blocking=False)   # producer role: weak, non-block
            # handle stays alive until the next drain (async send reads it)
            self._pending_handles.append(bh)
        self._maybe_release_pending()

    def _maybe_release_pending(self) -> None:
        if len(self._pending_handles) > self.PENDING_RELEASE_THRESHOLD:
            self.gsys.drain()
            self._release_pending()

    def _release_pending(self) -> None:
        for bh in self._pending_handles:
            self.gsys.heap.release(bh)
        self._pending_handles.clear()

    def serve_echo(self, *, n_batches: int, reply_port: int,
                   n_requests: int | None = None) -> ServeStats:
        """Pure echo mode (the paper's microbenchmark). Stops after
        `n_requests` total packets if given, else after `n_batches`."""
        t0 = time.monotonic()
        done = 0
        while (self.stats.requests < n_requests if n_requests is not None
               else done < n_batches):
            reqs = self.poll_requests()
            if not reqs:
                continue
            # the echo payloads are staging-extent views: reply() stages
            # each into its send extent directly, no tobytes() detour
            self.reply(reqs, reply_port)
            self.counters.add(requests=len(reqs), batches=1)
            done += 1
        self.gsys.drain()
        self._release_pending()
        wall = time.monotonic() - t0
        self.counters.update(lambda s: setattr(s, "wall_s", wall))
        return self.stats

    def serve_model(self, serve_fn, params, cache, *, n_batches: int,
                    reply_port: int, max_tokens: int = 8,
                    n_requests: int | None = None,
                    max_idle_polls: int = 50,
                    batch_decode: bool = False,
                    per_request_tokens: bool = False) -> ServeStats:
        """Decode-loop mode: each request's payload is int32 prompt tokens;
        respond with greedily decoded continuations. Stops at whichever
        bound hits first: ``n_batches`` non-empty batches, ``n_requests``
        total requests (if given), or ``max_idle_polls`` consecutive empty
        polls while waiting on ``n_requests`` — so a lost datagram cannot
        strand the loop forever.

        ``batch_decode=True`` decodes the whole poll batch together:
        requests are bucketed to a power-of-two batch size (bounded jit
        recompiles in the reference; a bounded set of shapes here) and
        each token step is ONE ``serve_fn`` dispatch for the bucket
        instead of one per request; the bucket's replies then fan out
        through the existing ring/tenant send path as one multi-entry
        submission. Default ``False`` keeps the eager per-request replies
        (minimum per-request latency; one dispatch per request per
        token).

        ``per_request_tokens=True`` switches the wire format to
        ``[budget, tag, prompt...]`` int32 (replies echo ``[tag,
        gens...]``): each request decodes its OWN token budget, capped at
        ``max_tokens`` steps per bucket member — the mixed-length workload
        the continuous engine is benchmarked against."""
        t0 = time.monotonic()
        done = 0
        idle = 0
        cache_len = torch.zeros((cache_batch_size(cache),),
                                dtype=torch.int32,
                                device=_first_leaf(cache).device)
        while done < n_batches and (
                n_requests is None or self.stats.requests < n_requests):
            reqs = self.poll_requests()
            if not reqs:
                idle += 1
                if n_requests is not None and idle >= max_idle_polls:
                    break               # traffic died before the target
                continue
            idle = 0
            tracer = self.gsys.tracer
            ch = tracer.channel("requests") if tracer is not None else None
            t_parse = time.perf_counter_ns()
            adm = self.admission if per_request_tokens else None
            parsed = [parse_request(r, per_request_tokens, max_tokens,
                                    with_client=adm is not None)
                      for r in reqs]
            if adm is not None:
                # admission decisions before anything queues: sheds are
                # answered now ([SHED_TOKEN]), degrades lose half their
                # token budget, admits pass through untouched
                kept = []
                for toks_i, budget, tag, client in parsed:
                    verdict = adm.admit_request(client)
                    if verdict == "shed":
                        self.reply([encode_reply([SHED_TOKEN], tag)],
                                   reply_port)
                        self.counters.add(shed_requests=1)
                        continue
                    if verdict == "degrade":
                        budget = max(1, budget >> 1)
                        self.counters.add(degraded_requests=1)
                    kept.append((toks_i, budget, tag, client))
                parsed = kept
            toks = [p[0] for p in parsed]
            budgets = [p[1] for p in parsed]
            tags = [p[2] for p in parsed]
            clients = [p[3] if len(p) > 3 else None for p in parsed]
            spans = [0] * len(parsed)
            if ch is not None:
                spans = [tracer.next_seq() for _ in parsed]
                for sp, b in zip(spans, budgets):
                    ch.rec(EV_REQ_BEGIN, REQ_SYSNO, sp, aux=b, ts=t_parse)
            if batch_decode:
                gens = _greedy_decode_batch(serve_fn, params, cache, toks,
                                            max_tokens, self.stats,
                                            budgets=(budgets if
                                                     per_request_tokens
                                                     else None))
                # the bucket's replies fan out through the tenant/ring
                # send path as ONE multi-entry submission (not attributable
                # to a single request span, so no span context here)
                self.reply([encode_reply(gn, tag)
                            for gn, tag in zip(gens, tags)], reply_port)
                self.counters.add(tokens_out=sum(len(gn) for gn in gens))
                end = time.perf_counter_ns()
                for sp, gn in zip(spans, gens):
                    if sp:
                        ch.rec(EV_REQ_END, REQ_SYSNO, sp, aux=len(gn),
                               ts=end)
                wall_us = (end - t_parse) / 1e3
                self._wall_hist.observe_block([wall_us] * len(parsed))
                if adm is not None:
                    for client in clients:
                        adm.observe(client, wall_us)
            else:
                for t, n_i, tag, sp, client in zip(toks, budgets, tags,
                                                   spans, clients):
                    t1 = time.perf_counter_ns()
                    gen = _greedy_decode(serve_fn, params, cache, cache_len,
                                         t, n_i)
                    # reply eagerly, per request: earlier requests in a
                    # batch are not held hostage by later ones' decode
                    # steps (the ring/tenant send is async, so this costs
                    # one SQE each)
                    if sp:
                        with tracer.span(sp):
                            self.reply([encode_reply(gen, tag)], reply_port)
                        ch.rec(EV_REQ_END, REQ_SYSNO, sp, aux=len(gen))
                    else:
                        self.reply([encode_reply(gen, tag)], reply_port)
                    wall_us = (time.perf_counter_ns() - t1) / 1e3
                    self._wall_hist.observe(wall_us)
                    if adm is not None:
                        adm.observe(client, wall_us)
                    self.counters.add(tokens_out=len(gen),
                                      decode_dispatches=n_i,
                                      decode_steps=n_i)
            self.counters.add(requests=len(reqs), batches=1)
            done += 1
        self.gsys.drain()
        self._release_pending()
        wall = time.monotonic() - t0
        self.counters.update(lambda s: setattr(s, "wall_s", wall))
        return self.stats

    def serve_model_continuous(self, engine, *, reply_port: int,
                               n_requests: int | None = None,
                               max_tokens: int = 8,
                               max_idle_polls: int = 50,
                               per_request_tokens: bool = True
                               ) -> ServeStats:
        """Continuous-batching decode loop: the engine decodes every step
        at ONE fixed batch shape while this loop admits arrivals and
        retires/answers finishers between steps — a request that lands
        mid-decode joins the NEXT step instead of waiting for the current
        bucket to drain (serving/engine.py).

        While slots are busy, polls wait ~0 so admission never stalls the
        batch — and are SKIPPED outright when admission is impossible
        this step (no free slot, or the queue already covers the free
        ones): arrivals sit in the kernel socket buffer and are swept up
        right after the next retirement, so a saturated engine pays zero
        poll latency per decode step. When the engine idles, polls block
        the socket's idle timeout. Stops once ``n_requests`` requests
        are answered (or after ``max_idle_polls`` idle polls with
        nothing in flight).

        With tracing on, every request gets a **span id** at parse time:
        REQ_BEGIN/REQ_END events bracket its wall time, the engine
        records one EV_STEP per span per decode dispatch, and admission/
        retirement/reply syscalls submitted under ``Tracer.span`` carry
        the id in their SUBMIT aux — ``export_chrome_trace`` renders one
        pid-5 track per request nesting its steps and syscalls.
        """
        t0 = time.monotonic()
        engine.serve_stats = self.counters
        tracer = self.gsys.tracer
        ch = tracer.channel("requests") if tracer is not None else None
        engine.trace = ch
        adm = self.admission
        # queue entries: (toks, budget, tag, span, t_parse_ns, client)
        queue: list[tuple] = []
        idle = 0
        replied = 0
        while True:
            busy = engine.n_active > 0 or bool(queue)
            if n_requests is not None and replied >= n_requests:
                break
            if busy and len(queue) >= engine.free_slots:
                reqs = []           # nothing to admit into: don't block
                self.counters.add(poll_skips=1)
            else:
                reqs = self.poll_requests(idle_wait=0.001 if busy else None)
            if reqs:
                idle = 0
                self.counters.add(requests=len(reqs), batches=1)
                now_ns = time.perf_counter_ns()
                for r in reqs:
                    if adm is not None:
                        toks, budget, tag, client = parse_request(
                            r, per_request_tokens, max_tokens,
                            with_client=True)
                        verdict = adm.admit_request(client)
                        if verdict == "shed":
                            # answer now, queue nothing: the [SHED_TOKEN]
                            # reply is the wire-visible degradation signal
                            self.reply([encode_reply([SHED_TOKEN], tag)],
                                       reply_port)
                            self.counters.add(shed_requests=1)
                            replied += 1
                            continue
                        if verdict == "degrade":
                            budget = max(1, budget >> 1)
                            self.counters.add(degraded_requests=1)
                    else:
                        toks, budget, tag = parse_request(
                            r, per_request_tokens, max_tokens)
                        client = None
                    span = 0
                    if ch is not None:
                        span = tracer.next_seq()
                        ch.rec(EV_REQ_BEGIN, REQ_SYSNO, span, aux=budget,
                               ts=now_ns)
                    queue.append((toks, budget, tag, span, now_ns, client))
            elif not busy:
                idle += 1
                if n_requests is None or idle >= max_idle_polls:
                    break               # traffic died before the target
                continue
            # admit as many queued requests as slots/blocks allow — the
            # rest stay queued and retry after the next retirements
            while queue:
                toks, budget, tag, span, tns, client = queue[0]
                meta = (tag, span, tns, client)
                if span:
                    # admission syscalls (spill revivals, block touches)
                    # belong to this request's span
                    with tracer.span(span):
                        ok = engine.admit(toks, budget, meta=meta,
                                          span=span)
                else:
                    ok = engine.admit(toks, budget, meta=meta, span=span)
                if not ok:
                    break
                queue.pop(0)
            depth = len(queue)
            self.counters.update(lambda s: (
                setattr(s, "queue_depth", depth),
                setattr(s, "queue_depth_peak",
                        max(s.queue_depth_peak, depth))))
            for meta, gen in engine.step():
                tag, span, tns, client = meta
                if span:
                    with tracer.span(span):
                        self.reply([encode_reply(gen, tag)], reply_port)
                    ch.rec(EV_REQ_END, REQ_SYSNO, span, aux=len(gen))
                else:
                    self.reply([encode_reply(gen, tag)], reply_port)
                wall_us = (time.perf_counter_ns() - tns) / 1e3
                self._wall_hist.observe(wall_us)
                if adm is not None and client is not None:
                    # the burn-rate/windowed-p99 input the controller's
                    # next refresh() reads — closing the control loop
                    adm.observe(client, wall_us)
                self.counters.add(tokens_out=len(gen))
                replied += 1
        self.gsys.drain()
        self._release_pending()
        wall = time.monotonic() - t0
        self.counters.update(lambda s: setattr(s, "wall_s", wall))
        return self.stats

    def close(self) -> None:
        self._call(Sys.CLOSE, self.fd)
        self._release_pending()
        for h in self._rx_handles:
            self.gsys.heap.release(h)
        self._rx_handles = []
        self._rx_bufs = []


def _first_leaf(cache):
    """The first tensor of a cache, a tensor or a dict of them (keys in
    sorted order, as the reference's tree_leaves takes them)."""
    while isinstance(cache, dict):
        cache = cache[sorted(cache)[0]]
    return cache


def cache_batch_size(cache) -> int:
    return _first_leaf(cache).shape[1]


def parse_request(req: np.ndarray, per_request_tokens: bool,
                  default_tokens: int, with_client: bool = False):
    """Decode one datagram into ``(prompt_tokens, budget, tag)``.

    Plain format: the whole payload is int32 prompt tokens; the budget is
    the server-wide ``max_tokens`` and replies carry no tag. Per-request
    format (``per_request_tokens=True``): ``[budget, tag, prompt...]`` —
    the tag is echoed first in the reply so an open-loop client can match
    out-of-order completions to its requests.

    ``with_client=True`` (admission-controlled servers) reads one more
    word — ``[budget, tag, client, prompt...]`` — and returns the
    4-tuple ``(prompt_tokens, budget, tag, client)``: the client id the
    :class:`~repro_torch.core.genesys.admit.AdmissionController` maps to an
    admission group."""
    toks = np.frombuffer(req.tobytes(), dtype=np.int32)
    if not per_request_tokens:
        return (toks, default_tokens, None, None) if with_client \
            else (toks, default_tokens, None)
    budget = max(1, int(toks[0])) if len(toks) else 1
    tag = int(toks[1]) if len(toks) > 1 else 0
    if not with_client:
        return toks[2:], budget, tag
    client = int(toks[2]) if len(toks) > 2 else 0
    return toks[3:], budget, tag, client


def encode_reply(gen, tag: int | None) -> bytes:
    toks = ([] if tag is None else [tag]) + list(gen)
    return np.asarray(toks, dtype=np.int32).tobytes()


def _greedy_decode(serve_fn, params, cache, cache_len, prompt_toks,
                   max_tokens: int) -> list[int]:
    """One request's greedy continuation — shared by the GENESYS and CPU
    servers so the two benchmark paths decode identically.

    Every request starts from the same ``cache``, row 0 of which is the
    initial decode state. The port's serve step updates its cache in
    place (the reference's returns a new one, so its template is never
    written), so the request decodes on a copy of that row and the
    template stays as ``init_cache`` made it, whatever state the model
    carries (a hybrid's recurrent state is read whole at every step)."""
    cur = torch.full((1, 1), int(prompt_toks[-1]), dtype=torch.int32,
                     device=cache_len.device)
    gen: list[int] = []
    cl = cache_len
    c = _tile_cache(cache, 1)
    for _ in range(max_tokens):
        nxt, c = serve_fn(params, c, cur, cl[:1])
        gen.append(int(nxt[0]))
        cur = nxt.reshape(1, 1)
        cl = cl + 1
    return gen


MAX_DECODE_BUCKET = 64      # widest decode batch one jit dispatch covers


def _bucket_size(k: int) -> int:
    """Smallest power of two >= k: a bounded set of jit shapes, so decode
    recompiles at most log2(MAX_DECODE_BUCKET) times, ever."""
    return 1 << (max(1, int(k)) - 1).bit_length()


def _tile_cache(cache, kb: int):
    """Fresh per-request decode state, batched: every request decodes from
    the same *initial* cache (exactly what the per-request path does), so
    row 0 of the template cache is tiled to the bucket's batch size."""
    if isinstance(cache, dict):
        return {n: _tile_cache(leaf, kb) for n, leaf in cache.items()}
    return torch.repeat_interleave(cache[:, :1], kb, dim=1)


def _greedy_decode_batch(serve_fn, params, cache, prompts, max_tokens: int,
                         stats: ServeStats | None = None,
                         budgets: list[int] | None = None
                         ) -> list[list[int]]:
    """Greedy continuations for a whole request batch: one ``serve_fn``
    dispatch per token step per power-of-two bucket, instead of one per
    request — the dispatch amortization the ROADMAP called for.

    Semantically identical to mapping :func:`_greedy_decode` over
    ``prompts``: each request decodes from a fresh initial cache; padded
    bucket rows (zero tokens) decode garbage nobody reads.

    ``budgets`` gives per-request token counts: the bucket is CLOSED —
    it runs until its longest member finishes (capped at ``max_tokens``)
    and early finishers ride along as dead rows. That occupancy waste is
    exactly what the continuous engine eliminates (fig12).
    """
    gens: list[list[int]] = []
    # cap the bucket so an oversized poll batch splits instead of padding
    # to one huge pow2 (bounded jit shapes AND bounded padding waste)
    bucket = max(1, min(_bucket_size(len(prompts)), MAX_DECODE_BUCKET))
    for lo in range(0, len(prompts), bucket):
        chunk = prompts[lo:lo + bucket]
        want = ([max_tokens] * len(chunk) if budgets is None
                else [min(max(1, b), max_tokens)
                      for b in budgets[lo:lo + bucket]])
        k = len(chunk)
        kb = _bucket_size(k)
        c = _tile_cache(cache, kb)
        dev = _first_leaf(c).device
        cl = torch.zeros((kb,), dtype=torch.int32, device=dev)
        cur_np = np.zeros((kb, 1), np.int32)
        for i, t in enumerate(chunk):
            cur_np[i, 0] = t[-1]
        cur = torch.from_numpy(cur_np).to(dev)
        chunk_gens: list[list[int]] = [[] for _ in range(k)]
        steps = max(want)
        for _ in range(steps):
            nxt, c = serve_fn(params, c, cur, cl)
            step = nxt.reshape(-1)[:k].tolist()
            for i, v in enumerate(step):
                if len(chunk_gens[i]) < want[i]:
                    chunk_gens[i].append(v)
            cur = nxt.reshape(kb, 1)
            cl = cl + 1
        gens.extend(chunk_gens)
        if stats is not None:
            stats.decode_dispatches += steps
            stats.decode_steps += sum(want)
            stats.decode_buckets += 1
    return gens


class CpuBaselineUdpServer:
    """The paper's CPU path: plain socket loop, no GENESYS."""

    def __init__(self, *, port: int, payload: int = 4096):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", port))
        self.sock.settimeout(0.2)
        self.payload = payload
        self.stats = ServeStats()

    def serve_echo(self, *, n_batches: int, reply_port: int) -> ServeStats:
        t0 = time.monotonic()
        done = 0
        while done < n_batches:
            try:
                data, _ = self.sock.recvfrom(self.payload)
            except socket.timeout:
                continue
            self.sock.sendto(data, ("127.0.0.1", reply_port))
            self.stats.requests += 1
            self.stats.batches += 1
            done += 1
        self.stats.wall_s = time.monotonic() - t0
        return self.stats

    def serve_model(self, serve_fn, params, cache, *, n_batches: int,
                    reply_port: int, max_tokens: int = 8) -> ServeStats:
        """The classic host decode loop (Fig 1 left): the CPU owns the
        socket, babysits the accelerator, one request at a time. The
        comparison target for GenesysUdpServer.serve_model's ring path."""
        t0 = time.monotonic()
        done = 0
        cache_len = torch.zeros((cache_batch_size(cache),),
                                dtype=torch.int32,
                                device=_first_leaf(cache).device)
        while done < n_batches:
            try:
                data, _ = self.sock.recvfrom(self.payload)
            except socket.timeout:
                continue
            t = np.frombuffer(data, dtype=np.int32)
            gen = _greedy_decode(serve_fn, params, cache, cache_len, t,
                                 max_tokens)
            self.sock.sendto(np.asarray(gen, dtype=np.int32).tobytes(),
                             ("127.0.0.1", reply_port))
            self.stats.tokens_out += len(gen)
            self.stats.requests += 1
            self.stats.batches += 1
            done += 1
        self.stats.wall_s = time.monotonic() - t0
        return self.stats

    def close(self) -> None:
        self.sock.close()

"""Serving launcher of the PyTorch port: the UDP model server over GENESYS
network (and, with ``--continuous``, memory) syscalls of
``repro.launch.serve``, on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
      --port 9111 --reply-port 9112 [--batches 4] [--batch-decode] \\
      [--continuous] [--device cpu] [--reduced]

``--arch`` names a dense, VLM, MoE, hybrid or SSM model
(moonshot-v1-16b-a3b runs its expert FFNs through the grouped-matmul
kernel; zamba2-2.7b decodes through its recurrent state and the shared
block's dense KV cache, rwkv6-3b through its WKV state and token shifts;
``--continuous`` takes the dense and MoE transformers only, as the
reference's paged step does). Weights are
random, drawn from seed 0. Requests are int32 datagrams (``[budget, tag,
prompt...]`` with ``--per-request-tokens``),
each answered with its greedy continuation. Without ``--continuous`` the loop
decodes over a dense cache of one row and 256 positions, each request
eagerly or, with ``--batch-decode``, each poll batch as one power-of-two
bucket, and exits after ``--batches`` non-empty poll batches. With
``--continuous`` it runs the continuous-batching engine over the
genesys.pagedkv arena and exits once it idles with nothing in flight.
"""
from __future__ import annotations

import argparse
import threading
import time


def start_stats_reporter(gsys, interval_s: float, *, out=print
                         ) -> tuple[threading.Thread, threading.Event]:
    """Start the ``--stats-interval`` reporter: a daemon thread printing
    one :func:`~repro_torch.core.genesys.trace.format_summary` line (rates
    from consecutive telemetry snapshots) every ``interval_s`` seconds via
    ``out``. Returns ``(thread, stop_event)``; set the event and join the
    thread for a clean shutdown."""
    from repro_torch.core.genesys import format_summary

    stop = threading.Event()

    def _report() -> None:
        prev, prev_t = None, time.monotonic()
        while not stop.wait(interval_s):
            snap = gsys.telemetry()
            now = time.monotonic()
            out(format_summary(snap, prev, now - prev_t))
            prev, prev_t = snap, now

    th = threading.Thread(target=_report, daemon=True, name="serve-stats")
    th.start()
    return th, stop


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of weights and KV arena")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--reply-port", type=int, required=True)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--use-ring", action="store_true",
                    help="decode-loop syscalls via the genesys.uring rings")
    ap.add_argument("--tenants", action="store_true",
                    help="per-tenant rings + QoS policies "
                         "(implies --use-ring)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the genesys.pagedkv "
                         "paged KV pool")
    ap.add_argument("--batches", type=int, default=4,
                    help="dense-cache serving: non-empty poll batches to "
                         "serve before exiting")
    ap.add_argument("--batch-decode", action="store_true",
                    help="dense-cache serving: bucket concurrent requests, "
                         "one decode dispatch per token step per bucket")
    ap.add_argument("--slots", type=int, default=8,
                    help="decode slots for --continuous")
    ap.add_argument("--kv-blocks", type=int, default=256,
                    help="paged KV arena blocks for --continuous")
    ap.add_argument("--block-size", type=int, default=16,
                    help="token positions per KV block for --continuous")
    ap.add_argument("--spill", default=None, metavar="PATH",
                    help="spill file for evicted prefix blocks "
                         "(PWRITE64 out, PREAD64_FIXED back)")
    ap.add_argument("--per-request-tokens", action="store_true",
                    help="wire format [budget, tag, prompt...]: each "
                         "request carries its own token budget")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable genesys.trace lifecycle telemetry and "
                         "write a Chrome-trace/Perfetto JSON here on exit")
    ap.add_argument("--stats-interval", type=float, default=0.0, metavar="N",
                    help="print a one-line telemetry summary every N s")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the genesys.metrics Prometheus exposition "
                         "over TCP (0 = ephemeral)")
    ap.add_argument("--slo-us", type=float, default=None, metavar="US",
                    help="declare a per-request latency SLO (µs)")
    ap.add_argument("--slo-target", type=float, default=0.999,
                    help="fraction of requests that must meet --slo-us")
    ap.add_argument("--admit", action="store_true",
                    help="SLO-driven admission control over --slo-class "
                         "groups (shed replies carry SHED_TOKEN)")
    ap.add_argument("--slo-class", action="append", default=[],
                    metavar="NAME:SLO_US[:TARGET[:RANK]]",
                    help="declare an admission class (repeatable)")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="deterministic fault injection: "
                         "'SEED[;TENANT:SYSNO:ERRNO:RATE]...'")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.genesys import (Genesys, GenesysConfig,
                                          StrictPriority, TokenBucket,
                                          WeightedFair, format_summary)
    from repro_torch.models.registry import get_api
    from repro_torch.models.transformer import DECODER_FAMILIES
    from repro_torch.serving.engine import make_engine
    from repro_torch.serving.server import GenesysUdpServer
    from repro_torch.train.steps import make_serve_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.continuous and cfg.family not in DECODER_FAMILIES:
        ap.error(f"--continuous takes the dense and MoE transformers only: "
                 f"{cfg.arch_id}'s recurrent state is not block-addressable")
    # pollers park after one empty round and sleep up to 50 ms (a
    # submission's edge wakes them): an eager decode step is hundreds of
    # small PyTorch calls, and a spinning or often-woken poller takes the
    # GIL between them (see chip_smoke.py's POLLER_SPIN)
    gsys = Genesys(GenesysConfig(n_workers=2, sched_pollers=2,
                                 ring_spin_polls=1, ring_max_sleep_s=0.05,
                                 trace=args.trace_out is not None))
    if args.tenants:
        gsys.use_policies(TokenBucket(), StrictPriority(), WeightedFair())
    if args.fault_plan:
        from repro_torch.core.genesys import FaultPlan
        plan = gsys.use_fault_plan(FaultPlan.parse(args.fault_plan))
        print(f"fault plan installed: seed={plan.seed} "
              f"rules={len(plan._rules)}", flush=True)
    controller = None
    if args.admit:
        from repro_torch.core.genesys import AdmissionController
        controller = AdmissionController(gsys.metrics)
        classes = []
        for spec in (args.slo_class or ["default:50000"]):
            parts = spec.split(":")
            slo = float(parts[1]) if len(parts) > 1 else None
            target = float(parts[2]) if len(parts) > 2 else 0.999
            rank = int(parts[3]) if len(parts) > 3 else 0
            classes.append(controller.declare(
                parts[0], slo_us=slo, target=target, priority_class=rank))
        controller.map_default(
            lambda cid, _c=classes: _c[int(cid) % len(_c)].name)
        controller.install(gsys)
        print(f"admission control on: "
              f"{', '.join(c.name for c in classes)}", flush=True)

    reporter = stop_stats = None
    if args.stats_interval > 0:
        reporter, stop_stats = start_stats_reporter(
            gsys, args.stats_interval,
            out=lambda line: print(line, flush=True))
    metrics_srv = None
    if args.metrics_port is not None:
        from repro_torch.core.genesys.metrics import MetricsHttpServer
        if args.slo_us is not None:
            gsys.metrics.set_slo("genesys_request_wall_us", args.slo_us,
                                 target=args.slo_target)
        metrics_srv = MetricsHttpServer(gsys.metrics,
                                        port=args.metrics_port,
                                        telemetry_fn=gsys.telemetry)
        print(f"metrics exposition on :{metrics_srv.port} "
              f"(/metrics, /telemetry)", flush=True)
    api = get_api(cfg)
    params = api.init(cfg, seed=0, device=args.device)
    srv = GenesysUdpServer(gsys, port=args.port, use_ring=args.use_ring,
                           use_tenants=args.tenants, admission=controller)
    if args.continuous:
        engine = make_engine(cfg, params, n_slots=args.slots,
                             n_blocks=args.kv_blocks,
                             block_size=args.block_size, gsys=gsys,
                             spill_path=args.spill)
        engine.admission = controller
        stats = srv.serve_model_continuous(
            engine, reply_port=args.reply_port, max_tokens=args.max_tokens,
            per_request_tokens=args.per_request_tokens)
        print(f"engine: occupancy={engine.stats.occupancy():.2f} "
              f"prefill_saved={engine.stats.prefill_steps_saved} "
              f"kv_hit_rate={engine.pool.stats.hit_rate():.2f} "
              f"kv_rss={engine.pool.rss_bytes()}")
    else:
        cache = api.init_cache(cfg, 1, 256, device=args.device)
        stats = srv.serve_model(
            make_serve_step(cfg), params, cache, n_batches=args.batches,
            reply_port=args.reply_port, max_tokens=args.max_tokens,
            batch_decode=args.batch_decode,
            per_request_tokens=args.per_request_tokens)
    print(f"requests={stats.requests} batches={stats.batches} "
          f"tokens={stats.tokens_out} wall={stats.wall_s:.2f}s "
          f"decode_dispatches={stats.decode_dispatches} "
          f"decode_steps={stats.decode_steps}")
    if args.tenants:
        for name, t in sorted(gsys.tenants().items()):
            print(f"tenant {name}: submitted={t.stats.submitted} "
                  f"reaped={t.stats.reaped} throttled={t.stats.throttled}")
    if controller is not None:
        a = controller.counters.snapshot()
        print(f"admit: admitted={a['admitted']} degraded={a['degraded']} "
              f"shed={a['shed']} level={a['shed_level']:.2f}")
    if reporter is not None:
        stop_stats.set()
        reporter.join(timeout=2)
        print(format_summary(gsys.telemetry()), flush=True)
    if metrics_srv is not None:
        metrics_srv.close()
    srv.close()
    if args.trace_out:
        gsys.export_chrome_trace(args.trace_out)
        print(f"chrome trace written to {args.trace_out}", flush=True)
    gsys.shutdown()


if __name__ == "__main__":
    main()

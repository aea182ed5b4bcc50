"""The benchmark of the PyTorch and CUDA port, one cell a run:

  python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration, read
from ``bench/configs/<config>.json``, and a traffic mix, read from
``bench/traffic/<mix>.json``, whose ``driver`` names the module under
``bench/drivers/`` that runs it. Its limits are ``bench/limits/<cell>.json``
and each per-layer metric is read by ``bench/metrics/<metric>.py``. The
last line of standard output is the result, one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    """The ``read(run)`` of ``bench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", BENCH / "metrics" /
        f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, workload: str) -> dict:
    """The workload entry and what it names: its config, mix, limits and
    per-layer metrics."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(entries)}")
    w = entries[workload]
    return {"entry": w,
            "cfg": load_json(BENCH / "configs" / f"{w['config']}.json"),
            "mix": load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{workload}.json"),
            "per_layer": [m["name"] for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]}


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every compile cache inside the checkout, at a fixed path (the
    # program's own kernels build into build/kernels/<hash>/ there)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    imported = time.perf_counter() - STARTED

    bench = load_json(ROOT / "BENCHMARK.json")
    c = cell(bench, args.workload)
    chips = c["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(f"bench.drivers.{c['mix']['driver']}")
    job = driver.Job(cfg=c["cfg"], mix=c["mix"],
                     seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda:0",
                     started=STARTED, limits=c["limits"],
                     readers={n: reader(n) for n in c["per_layer"]}
                     if args.trace else {})
    out = driver.run(job)
    out["_setup"] = {"imports": imported, **out.get("_setup", {})}
    report(out)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return emit(out, units)


def report(out: dict) -> None:
    """The readings behind the comparison and the set-up's phases (seconds
    from the process's start to the end of each), to standard error."""
    print("setup: " + json.dumps(out["_setup"]), file=sys.stderr)
    r = out.get("_readings")
    if r:
        print("readings: " + json.dumps(r), file=sys.stderr)


def finite(v: float) -> float:
    """A reading that JSON can carry: a gap that is not finite as the
    largest float."""
    return v if math.isfinite(v) else sys.float_info.max


def emit(out: dict, units: dict) -> int:
    """The result line, each metric with its unit from ``BENCHMARK.json``,
    then the compared numbers beside their limits."""
    out = {k: v for k, v in out.items() if not k.startswith("_")}
    out["metrics"] = {k: {"value": v, "unit": units[k]}
                      for k, v in out["metrics"].items()}
    for v in out["compared"].values():
        v["value"] = finite(v["value"])
    print(json.dumps(out), flush=True)
    for name, v in out["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

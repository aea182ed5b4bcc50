"""Run cells of the port's dry run (``repro_torch.launch.dryrun.run_cell``),
each in a subprocess of its own with its own timeout and no card visible,
several at once, and record each cell's status, wall time and roofline.

  PYTHONPATH=src python experiments/torch_dryrun_cells.py \\
      [--cells ARCH:SHAPE ...] [--mesh single|multi] [--timeout S] \\
      [--jobs N] [--out FILE]

By default the MoE and hybrid train and prefill cells
(moonshot-v1-16b-a3b, arctic-480b and zamba2-2.7b at train_4k and
prefill_32k) on the single-pod mesh. A cell traces the full-width model on
fake tensors over a fake world of 256 (or 512) ranks: it allocates no
weights, but a train cell takes minutes of CPU time. Prints one line a
cell and writes the JSON list to ``--out`` (default
``build/dryrun_cells.json``); exits 0 once every cell has an answer, ok or
not.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = tuple(f"{arch}:{shape}"
              for arch in ("moonshot-v1-16b-a3b", "arctic-480b",
                           "zamba2-2.7b")
              for shape in ("train_4k", "prefill_32k"))
CODE = """import json, sys, traceback
from repro_torch.launch.dryrun import run_cell
try:
    out = run_cell({arch!r}, {shape!r}, {multi!r})
except Exception:
    out = {{"status": "error", "error": traceback.format_exc()[-4000:]}}
print("CELL " + json.dumps(out), flush=True)
"""


def run_one(cell: str, multi: bool, timeout_s: float) -> dict:
    """One cell in a subprocess: its ``run_cell`` result (or the error)
    with the subprocess's wall time."""
    arch, shape = cell.split(":")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.monotonic()
    try:
        r = subprocess.run([sys.executable, "-c", CODE.format(
            arch=arch, shape=shape, multi=multi)], env=env,
            capture_output=True, text=True, timeout=timeout_s)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("CELL ")]
        res = (json.loads(line[0][len("CELL "):]) if line else
               {"status": "error", "error": (r.stdout + r.stderr)[-4000:]})
        res["rc"] = r.returncode
    except subprocess.TimeoutExpired:
        res = {"status": "timeout", "timeout_s": timeout_s}
    res.update(cell=cell, mesh="multi" if multi else "single",
               wall_s=time.monotonic() - t0)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS),
                    metavar="ARCH:SHAPE")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--timeout", type=float, default=1200.0)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "dryrun_cells.json"))
    args = ap.parse_args(argv)
    multi = args.mesh == "multi"
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(lambda c: run_one(c, multi, args.timeout),
                                args.cells))
    for r in results:
        rl = r.get("roofline", {})
        print(f"{r['cell']} ({r['mesh']}): {r['status']} in "
              f"{r['wall_s']:.1f} s"
              + (f", traced in {r.get('lower_s')} s; roofline compute "
                 f"{rl['compute_s'] * 1e3:.3f} ms, memory "
                 f"{rl['memory_s'] * 1e3:.3f} ms, collective "
                 f"{rl['collective_s'] * 1e3:.3f} ms -> {rl['bottleneck']}"
                 if rl else "")
              + (f"\n{r['error']}" if r.get("error") else ""), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

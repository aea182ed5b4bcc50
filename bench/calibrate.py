"""The readings that a training cell's limits are set from, in one process
on the chip, at the cell's own size:

  python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \\
      [--control 3] [--faults 3] [--out FILE]

For each seed the program's checked steps against the reference (the lower
readings); on the first ``--control`` seeds the reference computed in
float8 put in the program's place (the control, the upper readings); on
the first ``--faults`` seeds the program with each fault of
``bench.faults`` planted but ``unchanged``, which reads 1 by the measure.
One JSON line a reading on standard output, with ``correct`` as the
cell's limits in ``bench/limits/`` judge it, and all of them in ``--out``.
The benchmark's own runs never run this."""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings_for(cfg, mix, seed, dev, n_control, n_faults, index,
                 limits=None):
    from bench import check, faults
    from bench.drivers import train
    out = []

    def prepared():
        p = train.prepare(cfg, mix, seed, dev)
        p.close()
        return p

    t0 = time.perf_counter()
    p = prepared()
    shard, layout, model, kept = p.shard, p.layout, p.model, p.loader.kept
    sides = {"program": p.prog}
    del p
    train.free(dev)
    t1 = time.perf_counter()
    ref, differ = train.reference(model, cfg, layout, seed, dev,
                                  mix["optimizer"], shard, kept, "f32")
    t2 = time.perf_counter()
    if index < n_control:
        sides["control"], _ = train.reference(model, cfg, layout, seed, dev,
                                              mix["optimizer"], shard, kept,
                                              "fp8")
    if index < n_faults:
        for name in ("half_batch", "loss_altered"):
            with faults.FAULTS[name]():
                p = prepared()
            sides[name] = p.prog
            del p
            train.free(dev)
    for side, got in sides.items():
        r = check.readings(got, ref, differ if side == "program" else 0)
        quiet = set(r["_leaves"]["quiet"])
        judged = {} if limits is None else {
            "correct": check.judge(r, limits)[0]}
        out.append({"seed": seed, "side": side,
                    **{k: r[k] for k in check.NUMBERS}, **judged,
                    "leaves": r["_leaves"],
                    "grad_gaps": check.leaf_gaps(got["grad"], ref["grad"]),
                    "change_gaps": check.leaf_gaps(got["change"],
                                                   ref["change"], quiet),
                    "losses": got["losses"],
                    "ref_losses": ref["losses"],
                    "program_s": t1 - t0, "reference_s": t2 - t1})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.run import cell, load_json
    c = cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    dev = torch.device("cuda:0")
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for r in readings_for(c["cfg"], c["mix"], seed, dev, args.control,
                              args.faults, i, c["limits"]):
            rows.append(r)
            print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The scan kernels of one source tree, on one card: K4/K4b (the Mamba2
SSD scan, smoke phase 8) or K5/K5b (the RWKV-6 WKV, phase 11).

    python3 experiments/torch_ssd_compare.py --src SRC --tag TAG
        [--phase 8|11] [--out DIR]

Runs chip_smoke.py's phase (each case: forward and backward kernels beside
their plain versions, held to the smoke's rule, two backward calls
bit-equal, the bounds, and at L = 4096 each launch timed apart by kernel
name) against the kernels of ``SRC`` (a ``src`` directory: this
checkout's, or a parent's unpacked from ``git archive``). Writes
OUT/ssd_<TAG>.json for phase 8, OUT/wkv_<TAG>.json for phase 11 (OUT:
build/ssd_compare unless --out). Compare two trees only within one call on
the card, in turns (parent, change, change, parent): two calls may land on
two cards.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--phase", choices=("8", "11"), default="8")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ssd_compare")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ssd_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    _build.build()
    _build.library()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    if args.phase == "8":
        cases = cs.ssd_kernel_phase(torch, get_config("zamba2-2.7b"), dev,
                                    flush)
    else:
        cases = cs.wkv_kernel_phase(torch, get_config("rwkv6-3b"), dev, flush)
    for kind in ("fwd", "bwd"):
        for case in cases[kind]:
            print(f"{args.tag} {kind} {case['case']}: ms={case['ms']:.4f} "
                  f"launches {case.get('launches_ms')}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    stem = "ssd" if args.phase == "8" else "wkv"
    (args.out / f"{stem}_{args.tag}.json").write_text(json.dumps(
        {"src": str(args.src), "card": torch.cuda.get_device_name(0),
         "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The kernels of one source tree, on one card: K3a/K3b (the flash
attention, smoke phase 6), K4/K4b (the Mamba2 SSD scan, phase 8), K5/K5b
(the RWKV-6 WKV, phase 11) or K6/K6b (the MoE grouped matmul, phase 14).

    python3 experiments/torch_ssd_compare.py --src SRC --tag TAG
        [--phase 6|8|11|14] [--labels L ...] [--ptxas] [--out DIR]

Runs chip_smoke.py's phase (each case: forward and backward kernels beside
their plain versions, held to the smoke's rule, two backward calls
bit-equal, the bounds, the backward's launches timed apart; phase 6 also
its 3% control and SDPA) against the kernels of ``SRC`` (a ``src``
directory: this checkout's, or a parent's unpacked from ``git archive``).
Phase 6 runs the cases ``--labels`` names (``all``: every case; default:
the reduced configs' head dim 32: B 1, H 4, KV 2, causal, S 4096 and 1000
in bf16 and f32, and B 8 x S 64 in bf16). ``--ptxas`` prints what ``ptxas
-v`` said (registers, spills) of the phase's own kernels (``fa_*``,
``ssd_*``, ``wkv_*`` or ``gmm_*``; not the carry and sums the scans
share). Phase 14 prints each case's kernels beside ``torch.bmm`` and both
bounds (the design's and the f32 peak's). Writes OUT/fa_<TAG>.json for
phase 6, OUT/ssd_<TAG>.json for phase 8, OUT/wkv_<TAG>.json for phase 11,
OUT/gmm_<TAG>.json for phase 14 (OUT: build/ssd_compare unless --out).
Compare two trees only within one call on the card, in turns (parent,
change, change, parent): two calls may land on two cards.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# each phase's output stem and its kernels' entry-function name prefix
PHASES = {"6": ("fa", "fa_"), "8": ("ssd", "ssd_"), "11": ("wkv", "wkv_"),
          "14": ("gmm", "gmm_")}


def ptxas_lines(log: Path, prefix: str) -> list[str]:
    """The ptxas report's lines for the entry functions whose name holds
    ``prefix``: each one's name, then its registers, spills and shared
    memory."""
    out, keep = [], False
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            keep = prefix in line
        if keep and ("entry function" in line or "registers" in line
                     or "spill" in line):
            out.append(line.split("info    : ")[-1])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--phase", choices=tuple(PHASES), default="8")
    ap.add_argument("--labels", nargs="*", default=None)
    ap.add_argument("--ptxas", action="store_true")
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

    stem, prefix = PHASES[args.phase]
    lib = _build.build()
    _build.library()
    if args.ptxas:
        for line in ptxas_lines(lib.parent / "ptxas.log", prefix):
            print(f"{args.tag} ptxas: {line}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    if args.phase == "6":
        labels = (None if args.labels == ["all"] else args.labels
                  or [c[0] for c in cs.flash_cases_of(torch)
                      if c[5][2] == 32])
        cases = cs.flash_kernel_phase(torch, dev, flush, labels=labels)
    elif args.phase == "8":
        cases = cs.ssd_kernel_phase(torch, get_config("zamba2-2.7b"), dev,
                                    flush)
    elif args.phase == "11":
        cases = cs.wkv_kernel_phase(torch, get_config("rwkv6-3b"), dev, flush)
    else:
        cases = cs.gmm_kernel_phase(torch, get_config("moonshot-v1-16b-a3b"),
                                    dev, flush)
    for kind in ("fwd", "bwd"):
        for case in cases[kind]:
            extra = (f" sdpa={case['library_ms']:.4f} bound="
                     f"{case['bound_ms']:.4f} ({case['bound_by']}; SFU "
                     f"{case['bound_sfu_ms']:.4f}"
                     + ("" if case.get("bound_f32_ms") is None else
                        f"; f32 peak {case['bound_f32_ms']:.4f}")
                     + ") worst=" + "/".join(
                         f"{e['worst']:.3f}" for e in case["errors"].values())
                     if args.phase == "6" else "")
            if args.phase == "14":
                parts = case.get("parts", {})
                f32 = case["bound_f32_ms"]
                extra = (f" bmm={case['library_ms']:.4f} bound="
                         f"{case['bound_ms']:.4f} ({case['bound_by']}"
                         + ("" if f32 is None else f"; f32 peak {f32:.4f}")
                         + ") worst="
                         + "/".join(f"{e['worst']:.3f}"
                                    for e in case["errors"].values())
                         + " frob=" + "/".join(
                             f"{e['frob']:.2e}"
                             for e in case["errors"].values())
                         + "".join(f" {p}={v['ms']:.4f} (bmm "
                                   f"{v['library_ms']:.4f})"
                                   for p, v in parts.items()))
            print(f"{args.tag} {kind} {case['case']}: ms={case['ms']:.4f}"
                  f"{extra} launches {case.get('launches_ms')}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"{stem}_{args.tag}.json").write_text(json.dumps(
        {"src": str(args.src), "card": card, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

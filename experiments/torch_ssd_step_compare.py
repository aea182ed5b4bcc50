"""Smoke phase 9b's (or 12b's) train step, kernels against plain versions,
for one source tree's kernels, reporting every seed instead of stopping at
the first over its rule.

    python3 experiments/torch_ssd_step_compare.py --src SRC --tag TAG
        [--phase 9b|12b] [--seeds 21,22,23] [--out DIR]

Phase 9b: zamba2-2.7b, one group (6 mamba layers and the shared attention
block) at full width, Mamba2's decay draw. Phase 12b: rwkv6-3b, 2 blocks
at full width, RWKV-6's decay and bonus init. Either takes 2 x 4096
tokens in 2 microbatches: the bf16 step on the smoke's seed and on each of
``--seeds`` (by default the smoke's three more of that phase), and the
f32 step, each gradient leaf held by its relative norm to chip_smoke.py's
STEP_GRAD_REL. The bf16 readings of phase 9b sit near that rule (the worst
leaf is the shared block's wq), so a change to the scans' arithmetic is
read here against the parent's tree in the same call (parent, change,
change, parent). Writes OUT/ssd_step_<TAG>.json or OUT/wkv_step_<TAG>.json
(OUT: build/ssd_compare unless --out).
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
    ap.add_argument("--phase", choices=("9b", "12b"), default="9b")
    ap.add_argument("--seeds", default=None,
                    help="more bf16 seeds, comma-separated (default: the "
                         "smoke's for the phase)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ssd_compare")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ssd_step_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import mamba2_scan as ms
    from repro_torch.kernels import rwkv6_scan as wr
    from repro_torch.models import layers as L

    _build.build()
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    over = []

    def note(cond, what):       # every seed is read, none stops the run
        if not cond:
            over.append(what)
    cs.check = note
    dev = torch.device("cuda")
    if args.phase == "9b":
        cfg = get_config("zamba2-2.7b")
        seeds = args.seeds or "21,22,23"
        res = cs.step_kernel_vs_plain(
            torch, cfg, dev, layers=cfg.shared_attn_period,
            plain=ops.Kernels(attend=L.flash_attention_xla,
                              ssd=ms.ssd_chunked_plain),
            control=ops.Kernels(attend=L.flash_attention_xla,
                                ssd=cs.carry_dropped(ms.ssd_chunked_plain)),
            control_label="the SSD carry into chunk 32 dropped",
            prepare=lambda p, seed: cs.set_mamba2_decay(torch, p, seed=seed),
            bf16_seeds=tuple(int(v) for v in seeds.split(",")))
    else:
        cfg = get_config("rwkv6-3b")
        seeds = args.seeds or ",".join(map(str, cs.WKV_STEP_SEEDS))
        res = cs.step_kernel_vs_plain(
            torch, cfg, dev, layers=2,
            plain=ops.Kernels(wkv=wr.wkv6_chunked_plain),
            control=ops.Kernels(wkv=cs.carry_dropped(wr.wkv6_chunked_plain)),
            control_label="the WKV carry into chunk 32 dropped",
            prepare=lambda p, seed: cs.set_rwkv6_init(torch, p),
            bf16_seeds=tuple(int(v) for v in seeds.split(",")))
    print(f"{args.tag}: {len(over)} reading(s) over their rule", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    stem = "ssd_step" if args.phase == "9b" else "wkv_step"
    (args.out / f"{stem}_{args.tag}.json").write_text(json.dumps(
        {"src": str(args.src), "card": torch.cuda.get_device_name(0),
         "result": res, "over": over}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

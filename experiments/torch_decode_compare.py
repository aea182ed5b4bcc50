"""K1/K2 (the port's decode kernels) of one source tree, on one card.

    python3 experiments/torch_decode_compare.py --src SRC --tag TAG
        [--ablate merge|products] [--min-split-kb N] [--steps-only]
        [--out DIR]

Runs chip_smoke.py's phases 2 and 2b (each case: kernel beside its plain
version, masked SDPA, one plain read of its bytes and the bound, under the
smoke's L2 flush) against the kernels of ``SRC`` (a ``src`` directory:
this checkout's, or a parent's unpacked from ``git archive``), then times
K1 at the rows of phases 4 and 15's step alone, warm and back to back,
and alone after a read that leaves L2 clean and cold. Writes
OUT/decode_<TAG>.json (OUT: build/decode_compare unless --out). Compare
two trees only within one call on the card, in turns (parent, change,
change, parent): two calls may land on two cards.

``--ablate`` rebuilds a copy of SRC's ring kernel without the split merge
(no CTA of a row of several splits takes the last ticket) or without the
products (the loads and the softmax stay), to show what each costs; their
outputs are wrong, so only the step rows are timed.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "repro_torch/kernels/csrc/decode_common.cuh"
ABLATIONS = {
    "merge": [("if (tid == 0) last = ticket_acq_rel(tickets + b * KV + kvh) "
               "== n_run - 1;", "if (tid == 0) last = 0;")],
    "products": [("    Frags::scores(ks, qa, sc, lane);\n", ""),
                 ("    Frags::pv(ks + kStripe * Shape::kKStride, pa, o, "
                  "lane);\n", "")],
}
# the cached lens of phases 4 (starcoder2-7b) and 15 (moonshot-v1-16b-a3b)
# step alone, as chip_smoke.paged_state draws them: (H, KV, table, lens)
STEP_ROWS = {
    "starcoder2-step": (36, 4, 1024, [201, 916, 272, 488, 977, 412, 762, 348]),
    "moonshot-step": (16, 16, 512, [73, 150, 17, 915, 144, 591, 100, 420]),
}


def ablated(src: Path, what: str) -> Path:
    """A copy of ``src`` under build/ with the ring kernel edited."""
    dst = ROOT / "build" / f"decode_ablate_{what}" / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(src, dst)
    path = dst / KERNEL
    text = path.read_text()
    for old, new in ABLATIONS[what]:
        if old not in text:
            raise SystemExit(f"--ablate {what}: {old!r} not in {KERNEL}")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def step_ms(torch, ops, dev, reps: int = 48) -> dict:
    """K1 at each of STEP_ROWS, hd 128, bf16: device ms per call (1) over
    ``reps`` calls back to back, L2 warm (after three calls), and (2) the
    median of single calls after a read of 256 MB, which leaves L2 clean
    and cold, as a decode step meets a layer's cache after the other
    layers' weights went through."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    evict = torch.ones(128 << 20, dtype=torch.bfloat16, device=dev)
    out = {}
    for label, (h, kv, table, lens) in STEP_ROWS.items():
        B, BS, hd = len(lens), 16, 128
        pages = [(n + BS - 1) // BS for n in lens]
        bt = torch.zeros(B, table, dtype=torch.int32, device=dev)
        at = 1
        for b, p in enumerate(pages):
            bt[b, :p] = torch.arange(at, at + p, dtype=torch.int32,
                                     device=dev)
            at += p
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn(B, h, hd, generator=gen, device=dev).bfloat16()
        kp = torch.randn(at, BS, kv, hd, generator=gen,
                         device=dev).bfloat16()
        vp = torch.randn(kp.shape, generator=gen, device=dev).bfloat16()
        for _ in range(3):
            ops.paged_decode_attention(q, kp, vp, bt, lens_t)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(8_000_000)     # the host enqueues while it runs
        start.record()
        for _ in range(reps):
            ops.paged_decode_attention(q, kp, vp, bt, lens_t)
        end.record()
        torch.cuda.synchronize()
        warm = start.elapsed_time(end) / reps
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(20)]
        for s0, e0 in ev:
            evict.sum(dtype=torch.float32)
            torch.cuda._sleep(8_000_000)
            s0.record()
            ops.paged_decode_attention(q, kp, vp, bt, lens_t)
            e0.record()
        torch.cuda.synchronize()
        cold = sorted(s0.elapsed_time(e0) for s0, e0 in ev)[len(ev) // 2]
        out[label] = {"warm": warm, "cold_clean": cold}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--ablate", choices=sorted(ABLATIONS))
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "decode_compare")
    ap.add_argument("--min-split-kb", type=int,
                    help="the ring kernel's MIN_SPLIT_BYTES, in KB, for a "
                         "sweep (default: the module's)")
    ap.add_argument("--steps-only", action="store_true",
                    help="time the step rows only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_compare: no CUDA device", file=sys.stderr)
        return 2
    src = args.src.resolve()
    if args.ablate:
        src = ablated(src, args.ablate)
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as tda

    if not hasattr(tda, "variant"):      # a tree from before the ring kernel
        tda.variant = lambda q_dtype, hd: "before-ring"
    if args.min_split_kb:
        tda.MIN_SPLIT_BYTES = args.min_split_kb * 1024
    _build.build()
    _build.library()
    dev = torch.device("cuda")
    result = {"src": str(args.src), "ablate": args.ablate,
              "min_split_kb": args.min_split_kb,
              "card": torch.cuda.get_device_name(0)}
    if not (args.ablate or args.steps_only):
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        heads = {name: (c.n_heads, c.n_kv_heads, c.hd) for name, c in (
            (n, get_config(n)) for n in (
                "moonshot-v1-16b-a3b", "zamba2-2.7b", "seamless-m4t-medium"))}
        result["k1"], _ = cs.kernel_phase(torch, dev, flush,
                                          heads["moonshot-v1-16b-a3b"])
        result["k2"], _ = cs.dense_kernel_phase(
            torch, dev, flush, heads["zamba2-2.7b"],
            heads["moonshot-v1-16b-a3b"], heads["seamless-m4t-medium"])
        del flush
    result["step_ms"] = step_ms(torch, ops, dev)
    print(f"{args.tag}: K1 ms per call at the step rows "
          f"{result['step_ms']}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"decode_{args.tag}.json").write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K1/K2 (the port's decode kernels) of one source tree, on one card.

    python3 experiments/torch_decode_compare.py --src SRC --tag TAG
        [--ablate merge|products] [--stamps] [--min-split-kb N]
        [--steps-only] [--out DIR]

Runs chip_smoke.py's phases 2 and 2b (each case: kernel beside its plain
version, masked SDPA, one plain read of its bytes and the bound, under the
smoke's L2 flush; with the fused cases where the tree has them) against the
kernels of ``SRC`` (a ``src`` directory: this checkout's, or a parent's
unpacked from ``git archive``), then the decode step's append and attention
(:func:`fold_ms`): at the serving rows and the step rows of K1 and at K2's
one-row shapes, the append and the attention each alone, the two one after
the other, and, where the tree folds the append into K1/K2, the one launch
that does both, all under the flush; then K1 at the rows of phases 4 and
15's step alone, warm and back to back, and alone after a read that leaves
L2 clean and cold, without the step's token and (as the step calls it)
with it. Writes OUT/decode_<TAG>.json (OUT: build/decode_compare unless
--out). Compare two trees only within one call on the card, in turns
(parent, change, change, parent): two calls may land on two cards.

``--ablate`` rebuilds a copy of SRC's ring kernel without the split merge
(no CTA of a row of several splits takes the last ticket) or without the
products (the loads and the softmax stay), to show what each costs; their
outputs are wrong, so only the step rows are timed.

``--stamps`` rebuilds a copy of SRC with GENESYS_DECODE_STAMPS defined: the
CTA that merges a row's splits records %globaltimer at each step of the
merge (decode_common.cuh). At the step rows, cold-clean and warm, it
reads them after single calls and reports, over the (row, KV head) pairs
of several splits, the split-0 start to the last split's end, the ticket,
the (m, l) loads, part_o's staging, the products and the store.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import shutil
import statistics
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
    "stamps": [("#pragma once\n",
                "#pragma once\n#define GENESYS_DECODE_STAMPS 1\n")],
}
# the cached lens of phases 4 (starcoder2-7b) and 15 (moonshot-v1-16b-a3b)
# step alone, as chip_smoke.paged_state draws them: (H, KV, table, lens)
STEP_ROWS = {
    "starcoder2-step": (36, 4, 1024, [201, 916, 272, 488, 977, 412, 762, 348]),
    "moonshot-step": (16, 16, 512, [73, 150, 17, 915, 144, 591, 100, 420]),
}
# the stamps of decode_common.cuh, by index, and the intervals read
STAMP_PARTS = {"row_span": (7, 1), "own_split": (0, 1), "ticket": (1, 2),
               "ml_loads": (2, 3), "stage_o": (3, 4), "products": (4, 5),
               "store": (5, 6), "merge": (1, 6)}
N_STAMPS = 8


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


def folds(ops) -> bool:
    """Whether the tree's K1 takes the step's token (the fused append)."""
    return "slots" in inspect.signature(ops.paged_decode_attention).parameters


def step_inputs(torch, cs, dev, gen, h, kv, table, lens, hd=128):
    """K1's inputs at one of STEP_ROWS: q, pages on consecutive blocks from
    block 1, the block table and the lens, bf16; and the step's token
    (k_new, v_new) with its slot at position lens[b] - 1, whose rows then
    hold lens[b] - 1 cached positions (``cached``)."""
    B, BS = len(lens), cs.BS
    pages = [(n + BS - 1) // BS for n in lens]
    bt = torch.zeros(B, table, dtype=torch.int32, device=dev)
    at = 1
    for b, p in enumerate(pages):
        bt[b, :p] = torch.arange(at, at + p, dtype=torch.int32, device=dev)
        at += p
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(B, h, hd, generator=gen, device=dev).bfloat16()
    kp = torch.randn(at, BS, kv, hd, generator=gen, device=dev).bfloat16()
    vp = torch.randn(kp.shape, generator=gen, device=dev).bfloat16()
    k_new, v_new = (torch.randn(B, kv, hd, generator=gen, device=dev)
                    .bfloat16() for _ in range(2))
    cached = lens_t - 1
    slots = cs.token_slots(torch, bt, cached)
    return q, kp, vp, bt, lens_t, (cached, slots), (k_new, v_new)


def paged_calls(ops, fused_ok, q, kp, vp, bt, cached, slots, k_new, v_new):
    """The paged step's calls on K1's inputs: attend (K1 over cached + 1),
    append (the append kernel), both one after the other, and, where the
    tree folds them, the one launch."""
    lens1 = cached + 1

    def attend():
        return ops.paged_decode_attention(q, kp, vp, bt, lens1)

    def append():
        ops.update_kv_buffer(kp, vp, k_new, v_new, slots)

    def two_call():
        append()
        return attend()

    def fused():
        return ops.paged_decode_attention(q, kp, vp, bt, cached, k_new, v_new,
                                          slots)
    return attend, append, two_call, fused if fused_ok else None


def fold_ms(torch, cs, ops, dev, flush, fused_ok: bool) -> dict:
    """Device ms (chip_smoke.cuda_ms: medians of 20 calls, L2 flushed
    before each) of the decode step's append and attention, bf16: K1 at
    phase 2's serving rows (starcoder2's and moonshot's heads) and at
    STEP_ROWS, K2 at the one-row shapes of phase 2b (starcoder2, zamba2,
    moonshot, seamless: 255 cached positions and the token, written at
    position 255). Per case: ``attend_ms`` (K1 or K2 alone), ``append_ms``
    (the append kernel alone), ``two_call_ms`` (both, one after the
    other), ``fused_ms`` (the one launch, None for a tree without it)."""
    from repro_torch.configs import get_config

    heads = {n: (c.n_heads, c.n_kv_heads, c.hd) for n, c in (
        (n, get_config(n)) for n in ("starcoder2-7b", "moonshot-v1-16b-a3b",
                                     "zamba2-2.7b", "seamless-m4t-medium"))}
    out = {}

    def timed(label, attend, append, two_call, fused):
        r = {name: cs.cuda_ms(torch, fn, reps=20, flush=flush)[0]
             for name, fn in (("attend_ms", attend), ("append_ms", append),
                              ("two_call_ms", two_call))}
        r["fused_ms"] = (cs.cuda_ms(torch, fused, reps=20, flush=flush)[0]
                         if fused is not None else None)
        out[label] = r
        print(f"fold {label}: {r}", flush=True)

    gen = torch.Generator(device=dev)
    for label, arch, table in (
            ("serve", "starcoder2-7b", cs.N_BLOCKS // 2),
            ("moe-serve", "moonshot-v1-16b-a3b", cs.MOE_N_BLOCKS // 2)):
        gen.manual_seed(2)
        q, kp, vp, bt, lens, _ = cs.decode_inputs(
            torch, dev, gen, torch.bfloat16, torch.bfloat16, heads[arch],
            lens_range=(16, 288), table_width=table)
        cached = lens - 1
        slots = cs.token_slots(torch, bt, cached)
        k_new, v_new = (torch.randn(q.shape[0], *kp.shape[2:], generator=gen,
                                    device=dev).bfloat16() for _ in range(2))
        timed(label, *paged_calls(ops, fused_ok, q, kp, vp, bt, cached,
                                  slots, k_new, v_new))
    for label, (h, kv, table, lens) in STEP_ROWS.items():
        gen.manual_seed(5)
        q, kp, vp, bt, _, (cached, slots), (k_new, v_new) = step_inputs(
            torch, cs, dev, gen, h, kv, table, lens)
        timed(label, *paged_calls(ops, fused_ok, q, kp, vp, bt, cached,
                                  slots, k_new, v_new))
    S = cs.DENSE_LEN
    for label, arch in (("eager-row", "starcoder2-7b"),
                        ("hybrid", "zamba2-2.7b"),
                        ("moonshot", "moonshot-v1-16b-a3b"),
                        ("seamless", "seamless-m4t-medium")):
        gen.manual_seed(3)
        h, kv, hd = heads[arch]
        q = torch.randn(1, h, hd, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(1, S, kv, hd, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        k_new, v_new = (torch.randn(1, kv, hd, generator=gen, device=dev)
                        .bfloat16() for _ in range(2))
        cached = torch.full((1,), S - 1, dtype=torch.int32, device=dev)
        slots = cached.clone()

        def attend():
            return ops.decode_attention(q, k, v, cached, k_new, v_new)

        def append():
            ops.update_kv_buffer(k, v, k_new, v_new, slots)

        def two_call():
            o = attend()
            append()
            return o

        def fused():
            return ops.decode_attention(q, k, v, cached, k_new, v_new, slots)
        timed(label, attend, append, two_call, fused if fused_ok else None)
    return out


def k1_step_ms(torch, calls, reps: int = 48) -> dict:
    """Device ms per call of each of ``calls`` ({name: fn}): (1) over
    ``reps`` calls back to back, L2 warm (after three calls), and (2) the
    median of single calls after a read of 256 MB, which leaves L2 clean
    and cold, as a decode step meets a layer's cache after the other
    layers' weights went through."""
    evict = torch.ones(128 << 20, dtype=torch.bfloat16, device="cuda")
    out = {}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(8_000_000)     # the host enqueues while it runs
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        warm = start.elapsed_time(end) / reps
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(20)]
        for s0, e0 in ev:
            evict.sum(dtype=torch.float32)
            torch.cuda._sleep(8_000_000)
            s0.record()
            fn()
            e0.record()
        torch.cuda.synchronize()
        cold = sorted(s0.elapsed_time(e0) for s0, e0 in ev)[len(ev) // 2]
        out[name] = {"warm": warm, "cold_clean": cold}
    return out


def step_ms(torch, cs, ops, dev, fused_ok: bool) -> dict:
    """K1 at each of STEP_ROWS, hd 128, bf16, warm and cold-clean
    (:func:`k1_step_ms`): ``k1`` over the rows' lens without the token,
    and, where the tree folds the append, ``fused`` as the step calls it
    (lens - 1 cached positions and the token)."""
    gen = torch.Generator(device=dev)
    out = {}
    for label, (h, kv, table, lens) in STEP_ROWS.items():
        gen.manual_seed(5)
        q, kp, vp, bt, lens_t, (cached, slots), (k_new, v_new) = step_inputs(
            torch, cs, dev, gen, h, kv, table, lens)
        calls = {"k1": lambda: ops.paged_decode_attention(q, kp, vp, bt,
                                                          lens_t)}
        if fused_ok:
            calls["fused"] = lambda: ops.paged_decode_attention(
                q, kp, vp, bt, cached, k_new, v_new, slots)
        r = k1_step_ms(torch, calls)
        out[label] = dict(r["k1"], **({"fused": r["fused"]} if fused_ok
                                      else {}))
    return out


def merge_stamps(torch, cs, ops, tda, lib, dev, fused_ok: bool,
                 reps: int = 20) -> dict:
    """The merge's stamps at STEP_ROWS (a build with GENESYS_DECODE_STAMPS):
    for K1 without and (where the tree folds the append) with the step's
    token, cold-clean (single calls after a 256 MB read) and warm (the
    last of four calls back to back). Per interval of STAMP_PARTS, in µs:
    the median over calls of the median and of the largest over the
    (row, KV head) pairs of several splits; and each call's device time
    (events)."""
    fn = lib.decode_stamps_read
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    evict = torch.ones(128 << 20, dtype=torch.bfloat16, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    out = {}
    for label, (h, kv, table, lens) in STEP_ROWS.items():
        gen.manual_seed(5)
        q, kp, vp, bt, lens_t, (cached, slots), (k_new, v_new) = step_inputs(
            torch, cs, dev, gen, h, kv, table, lens)
        calls = {"k1": (lambda: ops.paged_decode_attention(
            q, kp, vp, bt, lens_t), lens)}
        if fused_ok:
            calls["fused"] = (lambda: ops.paged_decode_attention(
                q, kp, vp, bt, cached, k_new, v_new, slots),
                cached.tolist())
        for name, (call, row_lens) in calls.items():
            shortest = tda.min_split(128)
            ns = tda.ring_splits(len(lens), kv, table * 16, n_sm, shortest)
            split = tda.split_length(sum(row_lens), kv,
                                     tda.RING_RESIDENT_PER_SM * n_sm, shortest)
            runs = [tda.row_splits(n, ns, split)[0] for n in row_lens]
            pairs = [b * kv + x for b, n in enumerate(runs) if n > 1
                     for x in range(kv)]
            for mode in ("cold_clean", "warm"):
                per_call, ms = [], []
                for _ in range(reps):
                    if mode == "warm":
                        for _ in range(3):
                            call()
                    else:
                        evict.sum(dtype=torch.float32)
                    torch.cuda._sleep(8_000_000)
                    s0 = torch.cuda.Event(enable_timing=True)
                    e0 = torch.cuda.Event(enable_timing=True)
                    s0.record()
                    call()
                    e0.record()
                    torch.cuda.synchronize()
                    ms.append(s0.elapsed_time(e0))
                    buf = (ctypes.c_ulonglong * (len(lens) * kv * N_STAMPS))()
                    err = fn(ctypes.addressof(buf), len(buf))
                    if err:
                        raise RuntimeError(f"decode_stamps_read: {err}")
                    st = [buf[p * N_STAMPS:(p + 1) * N_STAMPS] for p in pairs]
                    per_call.append({
                        part: [(s[j] - s[i]) / 1e3 for s in st]
                        for part, (i, j) in STAMP_PARTS.items()})
                res = {"splits": runs, "pairs": len(pairs),
                       "call_ms": statistics.median(ms)}
                for part in STAMP_PARTS:
                    res[part] = {
                        "median_us": statistics.median(
                            statistics.median(c[part]) for c in per_call),
                        "max_us": statistics.median(
                            max(c[part]) for c in per_call)}
                out[f"{label}-{name}-{mode}"] = res
                print(f"stamps {label} {name} {mode}: "
                      f"call {res['call_ms']:.4f} ms, splits {runs}; " +
                      "; ".join(f"{p} {res[p]['median_us']:.3f} "
                                f"(max {res[p]['max_us']:.3f}) us"
                                for p in STAMP_PARTS), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--ablate", choices=sorted(set(ABLATIONS) - {"stamps"}))
    ap.add_argument("--stamps", action="store_true",
                    help="read the merge's %%globaltimer stamps at the step "
                         "rows (a stamped build) and nothing else")
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
    if args.ablate or args.stamps:
        src = ablated(src, args.ablate or "stamps")
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
    lib = _build.library()
    dev = torch.device("cuda")
    fused_ok = folds(ops)
    result = {"src": str(args.src), "ablate": args.ablate,
              "stamps": args.stamps, "min_split_kb": args.min_split_kb,
              "folds": fused_ok, "card": torch.cuda.get_device_name(0)}
    if args.stamps:
        result["stamps"] = merge_stamps(torch, cs, ops, tda, lib, dev,
                                        fused_ok)
    elif not (args.ablate or args.steps_only):
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        heads = {name: (c.n_heads, c.n_kv_heads, c.hd) for name, c in (
            (n, get_config(n)) for n in (
                "moonshot-v1-16b-a3b", "zamba2-2.7b", "seamless-m4t-medium"))}
        k1 = cs.kernel_phase(torch, dev, flush, heads["moonshot-v1-16b-a3b"],
                             fold=fused_ok)
        k2 = cs.dense_kernel_phase(
            torch, dev, flush, heads["zamba2-2.7b"],
            heads["moonshot-v1-16b-a3b"], heads["seamless-m4t-medium"],
            fold=fused_ok)
        result["k1"], result["k2"] = k1[0], k2[0]
        if fused_ok:
            result["k1_fused"], result["k2_fused"] = k1[1], k2[1]
        result["fold"] = fold_ms(torch, cs, ops, dev, flush, fused_ok)
        del flush
    if not args.stamps:
        result["step_ms"] = step_ms(torch, cs, ops, dev, fused_ok)
        print(f"{args.tag}: K1 ms per call at the step rows "
              f"{result['step_ms']}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"decode_{args.tag}.json").write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

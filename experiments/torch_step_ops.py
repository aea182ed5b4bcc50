"""Device operations and kernel launches of one decode step, of one tree.

    python3 experiments/torch_step_ops.py --src SRC --tag TAG [--out DIR]

For starcoder2-7b, zamba2-2.7b, rwkv6-3b, moonshot-v1-16b-a3b and
seamless-m4t-medium at full width and depth (random bf16 weights from seed
0), against the port of ``SRC`` (a ``src`` directory: this checkout's, or a
parent's unpacked from ``git archive``): one eager dense decode step (one
row at cached length 128 of the launchers' 256-position cache, as
chip_smoke.py's ``dense_step_alone``; seamless with its 4096 frames encoded
once beforehand) and, for the two paged families, one paged step of 8 rows
(chip_smoke.py's ``paged_state``, cached lengths up to 1024). Counts the
device operations of the step (torch.profiler's CUDA events with device
time: kernels, copies and sets, as ``chip_smoke.device_busy_ms``) and the
launches of K1, K2 and the KV append alone. Writes OUT/step_ops_<TAG>.json
(OUT: build/step_ops unless --out). Run parent and change in one call.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("starcoder2-7b", "zamba2-2.7b", "rwkv6-3b", "moonshot-v1-16b-a3b",
         "seamless-m4t-medium")
PAGED = ("starcoder2-7b", "moonshot-v1-16b-a3b")


def device_ops(torch, fn) -> int:
    """Device operations of one call of ``fn`` (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.self_device_time_total > 0)


def launches(ops, fn) -> dict:
    """K1's, K2's and the append's launches in one call of ``fn``."""
    counters = (ops.paged_decode_attention, ops.decode_attention,
                ops.update_kv_buffer)
    before = [c.launches for c in counters]
    fn()
    return {c.__name__: c.launches - n for c, n in zip(counters, before)}


def measure(torch, dev, cfgs, tag: str) -> dict:
    """{arch: its step's device operations and launches} for ``cfgs``."""
    import chip_smoke as cs
    from repro_torch.config import Family
    from repro_torch.kernels import ops
    from repro_torch.models import encdec, transformer
    from repro_torch.models.registry import get_api
    from repro_torch.train.steps import make_serve_step

    result = {}
    for cfg in cfgs:
        api = get_api(cfg)
        params = api.init(cfg, seed=0, device=dev)
        cache = api.init_cache(cfg, 1, cs.DENSE_LEN, device=dev)
        tok = torch.ones((1, 1), dtype=torch.int32, device=dev)
        cl = torch.full((1,), 128, dtype=torch.int32, device=dev)
        extra = ()
        if cfg.family == Family.ENCDEC:
            gen = torch.Generator(device=dev)
            gen.manual_seed(19)
            frames = cs.ar1_frames(torch, gen, 1, cfg.n_frame_tokens,
                                   cfg.d_model, dev).to(torch.bfloat16)
            with torch.no_grad():
                extra = (encdec.encode(params, cfg, frames),)
        step = make_serve_step(cfg)

        def dense():
            step(params, cache, tok, cl, *extra)
        row = {"dense_ops": device_ops(torch, dense),
               "dense_launches": launches(ops, dense)}
        if cfg.arch_id in PAGED:
            gen = torch.Generator(device=dev)
            gen.manual_seed(1)
            arenas, bt, pcl, ptok = cs.paged_state(
                torch, cfg, dev, gen, n_blocks=cs.MOE_N_BLOCKS
                if cfg.family == Family.MOE else cs.N_BLOCKS, max_len=1024)

            def paged():
                with torch.no_grad():
                    transformer.forward(params, cfg, ptok, cache_len=pcl,
                                        paged_cache=(arenas["k"],
                                                     arenas["v"], bt))
            row.update(paged_ops=device_ops(torch, paged),
                       paged_launches=launches(ops, paged))
            del arenas
        result[cfg.arch_id] = row
        print(f"{tag} {cfg.arch_id}: {row}", flush=True)
        del params, cache, extra
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "step_ops")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_step_ops: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    _build.build()
    _build.library()
    result = {"src": str(args.src), "card": torch.cuda.get_device_name(0)}
    result.update(measure(torch, torch.device("cuda"),
                          [get_config(a) for a in ARCHS], args.tag))
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"step_ops_{args.tag}.json").write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

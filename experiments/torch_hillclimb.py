"""Hillclimb driver of the PyTorch port (the counterpart of
``experiments/hillclimb.py``): run a named experiment variant of a
dry-run cell through the port's ``repro_torch.launch.dryrun.run_cell``
(fake world, H100 roofline constants) and append the result, with its
hypothesis, to ``experiments/torch_hillclimb.json``.

  PYTHONPATH=src python experiments/torch_hillclimb.py <variant-name>

The variants are the reference's, unchanged; their hypotheses were
written for the reference's TPU plan and are kept as written.
"""
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "torch_hillclimb.json"

# variant -> (arch, shape, multi_pod, kwargs, hypothesis)
VARIANTS = {
    # ---- Cell A: llava-next-34b train_4k (worst roofline fraction) -------
    "llava_train.baseline": (
        "llava-next-34b", "train_4k", False, {},
        "baseline: 56 heads don't divide TP16 -> head_dim-sharded attention "
        "all-reduces inside every flash chunk"),
    "llava_train.pad_heads64": (
        "llava-next-34b", "train_4k", False,
        {"cfg_overrides": {"n_heads": 64}},
        "pad q heads 56->64 (zero rows; exact function): heads shard 16-way "
        "cleanly, kv_rep=2 engages; predict collective drops ~10x for +14% "
        "attention flops"),
    "llava_train.pad_heads64_dots": (
        "llava-next-34b", "train_4k", False,
        {"cfg_overrides": {"n_heads": 64, "remat": "dots"}},
        "on top of head padding: save matmul outputs instead of full remat; "
        "predict compute term down ~15-20% (no fwd recompute), memory term "
        "up (saved activations)"),
    "llava_train.pad_heads64_mb8": (
        "llava-next-34b", "train_4k", False,
        {"cfg_overrides": {"n_heads": 64}, "microbatches": 8},
        "halve grad-accumulation depth (16->8): fewer FSDP weight gathers "
        "per step; predict collective down ~2x if gather-dominated, memory "
        "per-mb up 2x"),

    # ---- Cell B: arctic-480b train_4k (most collective-bound, MoE) -------
    "arctic_train.baseline": (
        "arctic-480b", "train_4k", False, {},
        "baseline: 56 heads (same sharding pathology) + GShard dispatch + "
        "128-expert FSDP gathers"),
    "arctic_train.pad_heads64": (
        "arctic-480b", "train_4k", False,
        {"cfg_overrides": {"n_heads": 64}},
        "head padding as in llava; predict the attention share of the "
        "collective term vanishes, MoE a2a remains"),
    "arctic_train.pad_heads64_mb8": (
        "arctic-480b", "train_4k", False,
        {"cfg_overrides": {"n_heads": 64}, "microbatches": 8},
        "fewer microbatches -> fewer expert-weight FSDP gathers per step "
        "(dominant wire term for 477B params); memory headroom permits 8"),
    "arctic_train.pad_heads64_mb8_g512": (
        "arctic-480b", "train_4k", False,
        {"cfg_overrides": {"n_heads": 64}, "microbatches": 8,
         "moe_group": 512},
        "double MoE dispatch group (256->512): halves dispatch/combine "
        "einsum flops overhead; predict compute term down, collectives flat"),

    # ---- Cell C: qwen2-72b decode_32k (paper-representative: serving) ----
    "qwen_decode.baseline": (
        "qwen2-72b", "decode_32k", False, {},
        "baseline: FSDP ON for serving -> full weight gather every token"),
    "qwen_decode.nofsdp": (
        "qwen2-72b", "decode_32k", False, {"fsdp": False},
        "serving should keep weights resident: bf16 weights 9GB/dev fit "
        "without FSDP; predict collective term collapses (no per-token "
        "gathers), memory term becomes weights+cache reads"),
    "qwen_decode.nofsdp_carried": (
        "qwen2-72b", "decode_32k", False, {"fsdp": False},
        "in-place carried KV cache (single-token DUS into the stacked "
        "buffer, no per-layer restack, no bf16<->f32 round-trip of the "
        "whole cache): predict memory term ~100x down to weights+cache "
        "reads (~25ms)"),
    "qwen_decode.nofsdp_carried_int8": (
        "qwen2-72b", "decode_32k", False,
        {"fsdp": False,
         "cfg_overrides": {"kv_cache_dtype": "int8"},
         "rules_overrides": {}},
        "int8 KV cache + carried in-place updates: cache 5.4TB->2.75TB "
        "global; with kv replication off it would be 1.37TB (5.4GB/dev) — "
        "predict memory term ~halves and peak fits closer to 16GB HBM"),
    "qwen_decode.nofsdp_batchboth": (
        "qwen2-72b", "decode_32k", False,
        {"fsdp": False,
         "rules_overrides": {"batch": ("data",), "kv_heads": "model"}},
        "control: explicit batch-on-data only (pod absent on single mesh); "
        "expect ~= nofsdp (validates rule plumbing)"),
    # ---- extensions: remaining collective-bound archs --------------------
    "starcoder_train.baseline": (
        "starcoder2-7b", "train_4k", False, {},
        "baseline: 36 heads vs TP16 -> head_dim-sharded attention (same "
        "pathology class as llava)"),
    "starcoder_train.pad_heads48": (
        "starcoder2-7b", "train_4k", False,
        {"cfg_overrides": {"n_heads": 48}},
        "pad 36->48 heads (48%16=0; kv=4 -> rep 4 -> KV_eff 16, G_pad 12%4=0 "
        "so replication engages): predict the llava-style 10x collective "
        "drop at +33% attention flops"),
    "seamless_decode.baseline": (
        "seamless-m4t-medium", "decode_32k", False, {},
        "baseline enc-dec decode: cross-attention recomputes K/V "
        "projections of the 4k encoder output every token"),
    "deepseek_train.seqshard": (
        "deepseek-67b", "train_4k", False,
        {"rules_overrides": {"seq": None}},
        "control: dense train with default rules (reference point for the "
        "sequence-parallel experiment below)"),
}


def main() -> None:
    from repro_torch.launch.dryrun import run_cell
    import repro_torch.models.moe as moe_mod

    name = sys.argv[1]
    arch, shape, mp, kw, hypothesis = VARIANTS[name]
    kw = dict(kw)
    grp = kw.pop("moe_group", None)
    if grp:
        moe_mod.GROUP_SIZE = grp
    out = run_cell(arch, shape, mp, **kw)
    out["variant"] = name
    out["hypothesis"] = hypothesis
    res = json.loads(OUT.read_text()) if OUT.exists() else {}
    res[name] = out
    OUT.write_text(json.dumps(res, indent=1, sort_keys=True))
    rl = out["roofline"]
    print(f"{name}: compute={rl['compute_s']:.2f}s memory="
          f"{rl['memory_s']:.2f}s collective={rl['collective_s']:.2f}s "
          f"bottleneck={rl['bottleneck']} useful={rl['useful_flops_ratio']:.3f} "
          f"peak={out['memory']['peak_bytes_dev']/2**30:.1f}GiB")


if __name__ == "__main__":
    main()

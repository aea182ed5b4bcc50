"""Multi-pod dry run of the PyTorch port (the counterpart of
``repro.launch.dryrun``): trace every (arch x input-shape) cell on the
production meshes and record memory, cost and collectives per device, and
their roofline terms on H100 constants.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # everything

A cell runs in this process as rank 0 of a fake world of ``mesh.size()``
ranks (``launch.mesh.make_production_mesh``): parameters, optimizer
state and inputs are DTensors placed by the sharding rules over fake
local shards (``FakeTensorMode``), nothing is allocated and no data
moves. The step runs once, as each device would run it, inside
``implicit_replication()`` and under ``perf.op_cost.OpCost``, which reads
its flops, bytes, collectives and peak live bytes from the local ops. It
needs no GPU. The step takes the plain versions of the kernels, as the
reference's dry run compiles its XLA paths: fake tensors carry no data
for a CUDA kernel. A decode cell takes seconds, a train cell minutes
(starcoder2-7b train_4k: 160 s on a 2-core host).

Results are cached incrementally in ``experiments/torch_dryrun.json``;
existing cells are skipped unless ``--force``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import weights
from repro_torch.config import SHAPES, ShapeKind, TrainConfig, shapes_for
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.mamba2_scan import ssd_chunked_plain
from repro_torch.kernels.moe_gmm import gmm_plain
from repro_torch.kernels.rwkv6_scan import wkv6_chunked_plain
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import layers as L
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import leaves
from repro_torch.perf.op_cost import OpCost
from repro_torch.perf.roofline import model_flops, roofline_terms
from repro_torch.sharding import (
    SSD_DIMS, WKV_DIMS, mesh_sizes, named_sharding, on_shards, rules_for,
    tree_shardings,
)
from repro_torch.train.steps import (
    make_prefill_step, make_serve_step, make_train_step,
)

RESULTS = Path(__file__).resolve().parents[3] / "experiments" / \
    "torch_dryrun.json"


def planned_append(k_pages, v_pages, k_new, v_new, slots):
    """The KV append as a plan runs it: each row's K/V written at its slot
    modulo the buffer's by one ``index_copy_``, the bytes the kernel
    moves. On DTensors each device writes its own rows into its own shard
    of the buffer (a row's slot modulo the shard's rows is its place
    there). A row past the end is not dropped: a plan has no data, and
    ``ops.update_kv_buffer_plain`` drops by a boolean mask whose size a
    plan cannot know."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(k_pages, DTensor):
        mesh = k_pages.device_mesh
        # a row [B,KV,hd] and its slot [B] split as the buffer [B,S,KV,hd]
        # splits its rows and heads
        row = [Shard({0: 0, 2: 1, 3: 2}[p.dim])
               if isinstance(p, Shard) and p.dim != 1 else Replicate()
               for p in k_pages.placements]
        slot = [p if p == Shard(0) else Replicate() for p in row]

        def local(t, placements):
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            return t.redistribute(mesh, placements).to_local()
        planned_append(k_pages.to_local(), v_pages.to_local(),
                       local(k_new, row), local(v_new, row),
                       local(slots, slot))
        return k_pages, v_pages
    NB, BS, KV, hd = k_pages.shape
    idx = slots.long() % (NB * BS)
    k_pages.view(NB * BS, KV, hd).index_copy_(0, idx, k_new)
    v_pages.view(NB * BS, KV, hd).index_copy_(0, idx, v_new)
    return k_pages, v_pages


# the plain versions of every kernel: the no-cache attention for training
# and prefill, the scans (each device on its rows and heads, so that no op
# of theirs, forward or backward, meets a DTensor), the carried decode (and
# decode-time cross-attention)
PLAIN = ops.Kernels(attend=on_shards(L.flash_attention_xla, (2, 2, 2)),
                    ssd=on_shards(ssd_chunked_plain, *SSD_DIMS),
                    wkv=on_shards(wkv6_chunked_plain, *WKV_DIMS),
                    gmm=gmm_plain)
PLAIN_DECODE = ops.Kernels(
    attend=on_shards(decode_attention_plain, (1, 2, 2, None, 1, 1)),
    gmm=gmm_plain, append=planned_append)


def batch_sharding_tree(cfg, mesh, rules, specs):
    """NamedShardings for a batch/decode spec dict."""
    def spec_for(name):
        if name in ("tokens", "labels"):
            return ("batch", "seq")
        if name in ("embeds", "enc_out"):
            return ("batch", "seq", "embed")
        if name == "token":
            return ("batch", None)
        if name == "cache_len":
            return ("batch",)
        raise KeyError(name)

    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = tree_shardings(mesh, rules,
                                    get_api(cfg).cache_axes(cfg), v)
        else:
            out[k] = named_sharding(mesh, rules, *spec_for(k),
                                    shape=tuple(v.shape))
    return out


def _cast_tree(tree, dtype):
    """The tree with floating leaves in ``dtype`` (bf16 serving)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _place(meta_tree, shardings, fake_mode):
    """DTensors over fake local shards (made in ``fake_mode``) for a tree
    of meta tensors."""
    from torch.distributed.tensor import DTensor
    if isinstance(meta_tree, dict):
        return {k: _place(v, shardings[k], fake_mode)
                for k, v in meta_tree.items()}
    sh = shardings
    with fake_mode:
        local = torch.empty(sh.shard_shape(tuple(meta_tree.shape)),
                            dtype=meta_tree.dtype)
    return DTensor.from_local(local, sh.mesh, sh.placements,
                              run_check=False, shape=meta_tree.shape,
                              stride=meta_tree.stride())


def _local_storages(tensors) -> dict:
    """{storage id: bytes} of the local shards of ``tensors``."""
    from torch.distributed.tensor import DTensor
    out = {}
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat(x)]
    if dataclasses.is_dataclass(tree):
        return leaves(tree)
    return [tree] if isinstance(tree, torch.Tensor) else []


def pick_microbatches(cfg, shape, batch_ways: int) -> int:
    """Grad-accumulation depth so saved activations fit HBM: target <=2
    sequences per device per microbatch for the big archs."""
    per_dev = max(1, shape.global_batch // batch_ways)
    target = 1 if cfg.d_model * cfg.n_layers >= 48 * 4096 else 2
    mb = max(1, per_dev // target)
    while shape.global_batch % (mb * batch_ways) and mb > 1:
        mb -= 1
    return mb


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             fsdp: bool = True, donate: bool = True,
             microbatches: int | None = None,
             serve_dtype: str = "bfloat16",
             rules_overrides: dict | None = None,
             cfg_overrides: dict | None = None) -> dict:
    """One cell on the production mesh, as the module docstring says.
    ``donate`` is the reference's buffer donation: the port's steps
    update parameters, optimizer state and cache in place, which is what
    donation buys, so it cannot be turned off."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    if not donate:
        raise ValueError("the port's steps update their state in place; "
                         "donate=False has no counterpart")
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = mesh_sizes(mesh)
    chips = mesh.size()
    rules = rules_for(cfg, mesh, fsdp=fsdp)
    # small batches (long_500k B=1) cannot shard the batch axis -> replicate
    batch_ways = sizes.get("pod", 1) * sizes.get("data", 1)
    if shape.global_batch % batch_ways != 0:
        rules = rules.with_overrides(batch=None)
        batch_ways = 1
    if rules_overrides:
        rules = rules.with_overrides(**rules_overrides)
    fsdp_axes = tuple(a for a in ("pod", "data") if a in sizes) \
        if fsdp else None

    api = get_api(cfg)
    p_meta = api.init(cfg, device="meta", master=True)
    if shape.kind != ShapeKind.TRAIN:
        p_meta = _cast_tree(p_meta, weights.torch_dtype(serve_dtype))
    p_shard = tree_shardings(mesh, rules, api.param_axes(cfg), p_meta,
                             fsdp_axes=fsdp_axes)
    specs = input_specs(cfg, shape, kv_rep=rules.kv_rep)
    b_shard = batch_sharding_tree(cfg, mesh, rules, specs)
    mb = microbatches if microbatches is not None else (
        pick_microbatches(cfg, shape, batch_ways)
        if shape.kind == ShapeKind.TRAIN else 1)

    # the local shards are fake tensors, but the mode that makes them is
    # not left on the dispatch stack: what DTensor computes to plan an op
    # (index tensors; global shapes in a fake mode of its own) runs as it
    # would anywhere, and only the ops on this mode's fake tensors, each
    # device's own work, are counted
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    cost = OpCost(counts=lambda t: isinstance(t, FakeTensor)
                  and t.fake_mode is fake_mode)
    t0 = time.time()
    with implicit_replication():
        params = _place(p_meta, p_shard, fake_mode)
        inputs = _place(specs, b_shard, fake_mode)
        if shape.kind == ShapeKind.TRAIN:
            ts, opt = make_train_step(cfg, TrainConfig(microbatches=mb),
                                      PLAIN, rules=rules)
            opt_state = opt.init(params)
            args = (params, opt_state, inputs)
        elif shape.kind == ShapeKind.PREFILL:
            ts = make_prefill_step(cfg, PLAIN, rules=rules)
            args = (params, inputs)
        else:
            sv = make_serve_step(cfg, PLAIN_DECODE, rules=rules)
            args = (params, inputs["cache"], inputs["token"],
                    inputs["cache_len"])
            if "enc_out" in inputs:
                args += (inputs["enc_out"],)
            ts = sv
        arg_tensors = _flat(args)
        arg_storages = _local_storages(arg_tensors)
        cost.hold(arg_tensors)
        with cost:
            out = ts(*args)
        out_storages = _local_storages(_flat(out))
    t_trace = time.time() - t0

    arg_bytes = sum(arg_storages.values())
    out_bytes = sum(out_storages.values())
    alias_bytes = sum(n for k, n in out_storages.items()
                      if k in arg_storages)
    peak = cost.peak_bytes
    temp_bytes = peak - arg_bytes - out_bytes + alias_bytes
    coll = cost.collectives
    mf = model_flops(cfg, shape)
    rl = roofline_terms(cost.flops, cost.bytes, coll.wire_bytes, mf, chips,
                        cross_node_wire_bytes_dev=coll.cross_node_wire_bytes)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "fsdp": fsdp,
        "microbatches": mb,
        "status": "ok",
        "lower_s": round(t_trace, 1),      # the traced run
        "compile_s": 0.0,                  # nothing is compiled
        "memory": {
            "argument_bytes_dev": arg_bytes,
            "output_bytes_dev": out_bytes,
            "temp_bytes_dev": temp_bytes,
            "alias_bytes_dev": alias_bytes,
            "peak_bytes_dev": peak,
        },
        "cost": {
            "flops_dev": cost.flops,
            "hbm_bytes_dev": cost.bytes,
            # lower bound: every live buffer touched exactly once
            "hbm_bytes_dev_lower": arg_bytes + out_bytes + temp_bytes,
            "unknown_trip_loops": 0,       # eager runs every trip
        },
        "collectives": {
            "wire_bytes_dev": coll.wire_bytes,
            "simple_bytes_dev": coll.simple_bytes,
            "cross_node_wire_bytes_dev": coll.cross_node_wire_bytes,
            "by_op": coll.by_op,
        },
        "roofline": rl.to_dict(),
    }


def cell_key(arch, shape_name, multi_pod, tag=""):
    return f"{arch}|{shape_name}|{'multi' if multi_pod else 'single'}{tag}"


def load_results() -> dict:
    if RESULTS.exists():
        return json.loads(RESULTS.read_text())
    return {}


def save_results(res: dict) -> None:
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    RESULTS.write_text(json.dumps(res, indent=1, sort_keys=True))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="disable ZeRO/FSDP storage sharding (default on)")
    args = ap.parse_args(argv)
    args.fsdp = not args.no_fsdp

    archs = all_arch_ids() if (args.all or not args.arch) \
        else [args.arch]
    res = load_results()
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        cfg = get_config(arch)
        shape_names = ([args.shape] if args.shape and not args.all
                       else [s.name for s in shapes_for(cfg)])
        for sn in shape_names:
            if SHAPES[sn] not in shapes_for(cfg):
                print(f"SKIP {arch} {sn}: long-context needs sub-quadratic "
                      f"attention (family={cfg.family.value})", flush=True)
                continue
            for mp in meshes:
                key = cell_key(arch, sn, mp, "" if args.fsdp else "|nofsdp")
                if key in res and res[key].get("status") == "ok" \
                        and not args.force:
                    print(f"CACHED {key}", flush=True)
                    continue
                print(f"RUN {key} ...", flush=True)
                try:
                    out = run_cell(arch, sn, mp, fsdp=args.fsdp)
                except Exception as e:  # noqa: BLE001 — record failures
                    out = {"arch": arch, "shape": sn,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                res[key] = out
                save_results(res)
                if out["status"] == "ok":
                    r = out["roofline"]
                    print(f"  ok: compute={r['compute_s']*1e3:.1f}ms "
                          f"memory={r['memory_s']*1e3:.1f}ms "
                          f"collective={r['collective_s']*1e3:.1f}ms "
                          f"bottleneck={r['bottleneck']} "
                          f"peak={out['memory']['peak_bytes_dev']/2**30:.2f}"
                          f"GiB (traced in {out['lower_s']}s)", flush=True)
                else:
                    print(f"  ERROR: {out['error']}", flush=True)


if __name__ == "__main__":
    main()

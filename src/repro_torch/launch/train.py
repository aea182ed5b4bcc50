"""Training launcher of the PyTorch port (the counterpart of
``repro.launch.train``), on one device or data parallel over a
``torchrun`` world.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
      --reduced --steps 100 --batch 8 --seq 128 [--data tokens.bin] \\
      [--ckpt-dir DIR [--ckpt-every N] [--resume]] [--device cpu]
  PYTHONPATH=src torchrun --standalone --nproc_per_node N \\
      -m repro_torch.launch.train --arch internlm2-20b --reduced ...

``--arch`` names any model of the dense, VLM, MoE, hybrid or SSM family
(moonshot-v1-16b-a3b trains its experts through the grouped-matmul
kernels; zamba2-2.7b trains through the chunked SSD scan, rwkv6-3b through
the chunked WKV; the sequence must then be a multiple of 64, or at most
64), or a preset of ``port_configs`` (moonlight-16b-a3b: latent attention
and dropless experts, on one device; its last line gives each MoE layer's
largest expert load over the mean, from the routed rows counted on the
device).

Weights are random, drawn from seed 0 and held as float32 master weights.
Batches come from a uint32 token shard through ``GenesysDataLoader``
(synthesised from seed 0 when ``--data`` is not given); checkpoints go
through ``CheckpointManager``. Train with ``--ckpt-dir``, stop, and run
again with ``--resume``: the second run continues from the last committed
step (the kill-and-resume of the reference's ``examples/train_lm.py``).

Data parallelism: under ``torchrun`` (``WORLD_SIZE`` set) the launcher
joins the process group (NCCL on the card ``LOCAL_RANK`` names, gloo with
``--device cpu``; a group the caller already started is used as it is),
builds the reference's ``make_host_mesh(data=world, model=1)`` and
``rules_for`` on it, and trains with ``rules``: parameters and optimizer
state are DTensors replicated over the ranks, each batch a DTensor split
over them by its rows (every rank reads the same global batch from the
same shard, as the reference's one process does, so a data-parallel step
is the one-process step), and the attention and the scans' kernels run on
each rank's rows (``sharding.on_shards``: the kernels take plain tensors).
The MoE expert products run on each rank's dispatch groups
(``sharding.gmm_on_shards``: the dispatched rows ``[E, n, C, D]`` split on
n), while routing, dispatch and combine stay on the DTensors, so the
groups, capacities and drops are those of one process; where the groups
do not divide over the ranks (one group of fewer than 256 tokens spans
them) every rank multiplies them all. The dense, VLM, MoE, hybrid and SSM
families; the encoder-decoder is refused: neither this launcher nor the
reference's trains it, since the loader gives tokens and no frames. The
parameters are
replicated, so global rank 0 alone writes a checkpoint, every rank waits
until its manifest is committed, and every rank restores it into its own
tensors (``checkpoint.ckpt``). Every rank prints its lines, prefixed
``[rank r/world]``: the losses, checkpoints, stragglers and the loader's
re-issued reads; each phase's milliseconds a step from the Trainer's
spans, on the host's clock and, for ``forward``, ``backward`` and
``optimizer`` on a card, between their device marks (``phases a step, ms
host / device: ...``); the last line the training kernels' launches in
this run (``kernel launches: {wrapper: n}``; 0 where the plain versions
ran, on the CPU).
"""
from __future__ import annotations

import argparse
import os
import tempfile


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights and optimizer state")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", default=None,
                    help="token shard (uint32); synthesized if omitted")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    return ap


def main(argv=None):
    """Train as the arguments say; returns the trainer's ``LoopStats``."""
    args = build_parser().parse_args(argv)

    import numpy as np

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.config import Family, TrainConfig
    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.data.pipeline import GenesysDataLoader, write_token_shard
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import ROUTED
    from repro_torch.models.registry import get_api
    from repro_torch.port_configs import get_config, is_mla
    from repro_torch.sharding import (
        SSD_DIMS, WKV_DIMS, gmm_on_shards, on_shards, rules_for,
    )
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import make_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if world and cfg.family == Family.ENCDEC:
        raise ValueError(f"data parallelism takes the dense, VLM, MoE, "
                         f"hybrid and SSM families, not "
                         f"{cfg.family.value} ({cfg.arch_id}): neither "
                         f"launcher trains it, the loader gives no frames")
    if world and is_mla(cfg):
        raise ValueError(f"{cfg.arch_id} trains on one device: its dropless "
                         f"dispatch has no sharded route")
    device, own_group, prefix = args.device, False, ""
    rules, kernels = None, ops.KERNELS
    if world:
        device, own_group = _join_world(device)
        rules = rules_for(cfg, make_host_mesh(data=world, model=1))
        # q [B,S,H,hd], k and v [B,S,KV,hd]: each rank attends its rows;
        # the scans run on them too, and the experts on its groups' rows
        kernels = ops.Kernels(
            attend=on_shards(ops.flash_attention, (2, 2, 2)),
            ssd=on_shards(ops.mamba2_ssd, *SSD_DIMS),
            wkv=on_shards(ops.rwkv6_wkv, *WKV_DIMS),
            gmm=gmm_on_shards(ops.gmm))
        prefix = f"[rank {rules.mesh.get_rank()}/{world}] "
    gsys = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=200,
                                 coalesce_max=8))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = args.data
            if data is None:
                data = os.path.join(tmp, "tokens.bin")
                write_token_shard(data, np.random.default_rng(0).integers(
                    0, min(cfg.vocab_size, 32000),
                    size=args.batch * (args.seq + 1) * 64).astype(np.uint32))
                print(f"{prefix}synthesized corpus at {data}")
            api = get_api(cfg)
            params = api.init(cfg, seed=0, device=device, master=True)
            ts, opt = make_train_step(cfg, TrainConfig(
                lr=args.lr, microbatches=args.microbatches), kernels,
                rules=rules)
            if rules is not None:
                params = _replicate(params, api.param_axes(cfg), rules)
                ts = _with_implicit_replication(ts)
            loader = GenesysDataLoader(gsys, [data], batch=args.batch,
                                       seq=args.seq)
            ckpt = (CheckpointManager(gsys, args.ckpt_dir) if args.ckpt_dir
                    else None)
            try:
                tr = Trainer(gsys, ts, params, opt.init(params), loader,
                             ckpt=ckpt, ckpt_every=args.ckpt_every,
                             rules=rules)
                if args.resume and tr.resume():
                    print(f"{prefix}resumed from step {tr.step}")
                counted = (ops.flash_attention_fwd, ops.flash_attention_bwd,
                           ops.mamba2_ssd_fwd, ops.mamba2_ssd_bwd,
                           ops.rwkv6_wkv_fwd, ops.rwkv6_wkv_bwd, ops.gmm_fwd,
                           ops.gmm_bwd)
                before = [c.launches for c in counted]
                ROUTED.reset()
                st = tr.run(args.steps)
                print(f"{prefix}steps={st.steps} loss[0]={st.losses[0]:.4f} "
                      f"loss[-1]={st.losses[-1]:.4f} ckpts={st.ckpts} "
                      f"stragglers={st.straggler_steps} straggler_reissues="
                      f"{loader.stats['straggler_reissues']}")
                print(f"{prefix}phases a step, ms host / device: "
                      + phase_line(tr.spans.closed()))
                print(f"{prefix}GENESYS: {dict(gsys.table.stats)} "
                      f"coalesce_hist={gsys.executor.stats.coalesce_hist}")
                print(f"{prefix}kernel launches: " + str(
                    {c.__name__: c.launches - n
                     for c, n in zip(counted, before)}))
                if is_mla(cfg):
                    print(f"{prefix}expert load max/mean by MoE layer: "
                          + load_line(ROUTED.read()))
            finally:
                loader.close()
    finally:
        gsys.shutdown()
        if own_group:
            import torch.distributed as dist
            dist.destroy_process_group()
    return st


def load_line(routed: dict) -> str:
    """Each MoE layer's largest count of routed rows over the mean of its
    experts': ``0 1.234, 1 1.111, ...``."""
    return ", ".join(f"{layer} {max(n) / (sum(n) / len(n)):.3f}"
                     for layer, n in routed.items() if sum(n))


def phase_line(spans: list) -> str:
    """Each span name's milliseconds a step (over the ``step`` spans
    there are), host and, where it had device marks, device:
    ``step 12.345, load 0.123, ..., forward 3.210 / 3.001, ...``."""
    steps = max(1, sum(s["name"] == "step" for s in spans))
    host, device = {}, {}
    for s in spans:
        host[s["name"]] = host.get(s["name"], 0) + s["end_ns"] - s["start_ns"]
        device[s["name"]] = device.get(s["name"], 0) + s["device_ns"]
    return ", ".join(
        f"{n} {host[n] / 1e6 / steps:.3f}"
        + (f" / {device[n] / 1e6 / steps:.3f}" if device[n] else "")
        for n in host)


def _join_world(device: str):
    """Join the ``torchrun`` world (``env://``): NCCL on the card
    ``LOCAL_RANK`` names, gloo for ``--device cpu``; a process group the
    caller started is used as it is. Returns (this rank's device, whether
    this call started the group)."""
    import torch
    import torch.distributed as dist

    if device != "cpu":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    if dist.is_initialized():
        return device, False
    dist.init_process_group("gloo" if device == "cpu" else "nccl")
    return device, True


def _replicate(params, axes, rules):
    """``params`` as DTensors placed by ``rules`` on its mesh (replicated
    there: the mesh's model dim has one rank)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding import tree_shardings

    sh = tree_shardings(rules.mesh, rules, axes, params)

    def place(p, s):
        if isinstance(p, dict):
            return {k: place(p[k], s[k]) for k in p}
        return distribute_tensor(p, rules.mesh, s.placements)
    return place(params, sh)


def _with_implicit_replication(train_step):
    """``train_step`` run inside DTensor's ``implicit_replication()``:
    plain tensors it meets beside DTensors (rope tables, AdamW's bias
    corrections, the step count) count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    def step(*args):
        with implicit_replication():
            return train_step(*args)
    return step


if __name__ == "__main__":
    main()

"""Training launcher of the PyTorch port (the counterpart of
``repro.launch.train``), on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
      --reduced --steps 100 --batch 8 --seq 128 [--data tokens.bin] \\
      [--ckpt-dir DIR [--ckpt-every N] [--resume]] [--device cpu]

``--arch`` names any model of the dense, VLM, MoE, hybrid or SSM family
(moonshot-v1-16b-a3b trains its experts through the grouped-matmul
kernels; zamba2-2.7b trains through the chunked SSD scan, rwkv6-3b through
the chunked WKV; the sequence must then be a multiple of 64, or at most
64).

Weights are random, drawn from seed 0 and held as float32 master weights.
Batches come from a uint32 token shard through ``GenesysDataLoader``
(synthesised from seed 0 when ``--data`` is not given); checkpoints go
through ``CheckpointManager``. Train with ``--ckpt-dir``, stop, and run
again with ``--resume``: the second run continues from the last committed
step (the kill-and-resume of the reference's ``examples/train_lm.py``).
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
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.data.pipeline import GenesysDataLoader, write_token_shard
    from repro_torch.models.registry import get_api
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import make_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gsys = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=200,
                                 coalesce_max=8))
    with tempfile.TemporaryDirectory() as tmp:
        data = args.data
        if data is None:
            data = os.path.join(tmp, "tokens.bin")
            write_token_shard(data, np.random.default_rng(0).integers(
                0, min(cfg.vocab_size, 32000),
                size=args.batch * (args.seq + 1) * 64).astype(np.uint32))
            print(f"synthesized corpus at {data}")
        params = get_api(cfg).init(cfg, seed=0, device=args.device,
                                   master=True)
        ts, opt = make_train_step(cfg, TrainConfig(
            lr=args.lr, microbatches=args.microbatches))
        loader = GenesysDataLoader(gsys, [data], batch=args.batch,
                                   seq=args.seq)
        ckpt = (CheckpointManager(gsys, args.ckpt_dir) if args.ckpt_dir
                else None)
        try:
            tr = Trainer(gsys, ts, params, opt.init(params), loader,
                         ckpt=ckpt, ckpt_every=args.ckpt_every)
            if args.resume and tr.resume():
                print(f"resumed from step {tr.step}")
            st = tr.run(args.steps)
            print(f"steps={st.steps} loss[0]={st.losses[0]:.4f} "
                  f"loss[-1]={st.losses[-1]:.4f} ckpts={st.ckpts} "
                  f"stragglers={st.straggler_steps}")
            print(f"GENESYS: {dict(gsys.table.stats)} "
                  f"coalesce_hist={gsys.executor.stats.coalesce_hist}")
        finally:
            loader.close()
            gsys.shutdown()
    return st


if __name__ == "__main__":
    main()

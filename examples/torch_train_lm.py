"""End-to-end driver in the PyTorch port: train a reduced LM with the full
GENESYS substrate (pread data prefetch, async pwrite checkpoints, madvise
memory hints, straggler watchdog), then kill and resume from checkpoint.

The model is ``--arch`` reduced (internlm2-20b by default), random f32
master weights from seed 0, trained on a synthesised shard of 2M uint32
tokens through ``GenesysDataLoader`` (8 x 64 tokens a step). Async
checkpoints go through ``CheckpointManager(keep=2)`` every
``--ckpt-every`` steps (``max(10, steps // 4)`` by default). Then a fresh
``Trainer`` on freshly initialised weights resumes from the last
committed step and trains 10 more. Prints the syscall counts and the
executor's coalescing histogram. Runs on the card unless ``--device cpu``
is given.

  PYTHONPATH=src python examples/torch_train_lm.py --arch internlm2-20b \\
      --steps 200 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.genesys import Genesys, GenesysConfig
from repro_torch.data.pipeline import GenesysDataLoader, write_token_shard
from repro_torch.models.registry import get_api
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import make_train_step

RESUME_STEPS = 10


def main(argv=None) -> dict:
    """Train, checkpoint, resume. Returns ``{"stats": LoopStats of the
    first run, "committed": the last committed step, "resumed_at": the
    step the resume landed on, "resume_losses": the 10 resumed steps'
    losses, "syscalls": the syscall counts}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-20b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default "
                         "max(10, steps // 4))")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights and optimizer state")
    args = ap.parse_args(argv)
    every = args.ckpt_every or max(10, args.steps // 4)

    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=200,
                              coalesce_max=8))
    out = {}
    try:
        with tempfile.TemporaryDirectory() as work:
            shard = os.path.join(work, "tokens.bin")
            write_token_shard(shard, np.random.default_rng(0).integers(
                0, 500, size=2_000_000).astype(np.uint32))
            cfg = get_config(args.arch).reduced()
            api = get_api(cfg)
            ts, opt = make_train_step(cfg, TrainConfig(lr=1e-3))
            loader = GenesysDataLoader(g, [shard], batch=8, seq=64,
                                       prefetch_depth=3)
            ckpt = CheckpointManager(g, os.path.join(work, "ckpt"), keep=2)
            try:
                params = api.init(cfg, seed=0, device=args.device,
                                  master=True)
                tr = Trainer(g, ts, params, opt.init(params), loader,
                             ckpt=ckpt, ckpt_every=every)
                stats = tr.run(args.steps)
                print(f"trained {stats.steps} steps: loss "
                      f"{stats.losses[0]:.3f} -> {stats.losses[-1]:.3f}; "
                      f"{stats.ckpts} async checkpoints")

                committed = ckpt.latest_step()

                # kill-and-resume (elastic restart path): a new trainer on
                # new weights takes the last committed step
                params = api.init(cfg, seed=0, device=args.device,
                                  master=True)
                tr2 = Trainer(g, ts, params, opt.init(params), loader,
                              ckpt=ckpt)
                if not tr2.resume():
                    raise RuntimeError("no committed checkpoint to resume "
                                       "from")
                resumed_at = tr2.step
                print(f"resumed at step {resumed_at}; continuing "
                      f"{RESUME_STEPS} more steps")
                resumed = tr2.run(RESUME_STEPS)
                out.update(stats=stats, committed=committed,
                           resumed_at=resumed_at,
                           resume_losses=resumed.losses)
            finally:
                loader.close()
        out["syscalls"] = dict(g.table.stats)
        print(f"GENESYS syscalls: {out['syscalls']}")
        print(f"coalescing histogram: {g.executor.stats.coalesce_hist}")
    finally:
        g.shutdown()
    return out


if __name__ == "__main__":
    main()

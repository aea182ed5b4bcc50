"""miniAMR-style adaptive memory (paper §7.2) in the PyTorch port: a
refinement loop releases coarse-phase buffers with madvise(DONTNEED) via
GENESYS, shrinking RSS.

Three phases, each finer than the last: a phase maps and touches its host
buffer through the GENESYS memory pool, runs three stencil sweeps over its
grid on the device, and then releases the previous phase's buffer with a
weak, non-blocking MADVISE(DONTNEED). RSS is printed after each phase and
after each release. Runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_memory_hints.py [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.genesys import Genesys, GenesysConfig, Sys
from repro_torch.core.genesys.memory_pool import MADV_DONTNEED

MB = 1024 * 1024
# (refinement level, host buffer bytes) of each phase
PHASES = ((4, 128 * MB), (2, 32 * MB), (1, 8 * MB))


def stencil(x: torch.Tensor) -> torch.Tensor:
    """One three-point sweep along the rows, periodic."""
    return (x + torch.roll(x, 1, 0) + torch.roll(x, -1, 0)) / 3.0


def main(argv=None) -> dict:
    """Run the three phases; returns ``{"rss_mb": [after each phase],
    "released_rss_mb": [after each release]}`` in MB, as printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the stencil's grids")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g = Genesys(GenesysConfig(n_workers=2))
    out = {"rss_mb": [], "released_rss_mb": []}
    try:
        prev = None
        for phase, (level, nbytes) in enumerate(PHASES):
            addr = g.pool.mmap(nbytes)
            g.pool.touch(addr)
            x = torch.ones((256 * level, 256), dtype=torch.float32,
                           device=dev)
            for _ in range(3):
                x = stencil(x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            rss = g.pool.rss_bytes // MB
            out["rss_mb"].append(rss)
            print(f"phase {phase} (refinement {level}): RSS = {rss} MB")
            if prev is not None:
                # release the previous phase: non-blocking weak madvise
                # (paper §7.2)
                g.call(Sys.MADVISE, prev[0], prev[1], MADV_DONTNEED,
                       blocking=False)
                g.drain()
                rss = g.pool.rss_bytes // MB
                out["released_rss_mb"].append(rss)
                print(f"  after madvise(DONTNEED): RSS = {rss} MB")
            prev = (addr, nbytes)
    finally:
        g.shutdown()
    return out


if __name__ == "__main__":
    main()

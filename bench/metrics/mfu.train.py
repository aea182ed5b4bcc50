"""mfu.train: model FLOPs of the window's steps (``bench.flops.model_flops``
from the configuration file's widths, recomputation not counted) over the
window's time, as a share of the card's bf16 peak."""

from bench import flops


def read(run):
    if not run.steps:
        return None
    work = flops.model_flops(run.cfg, run.rows, run.seq) * len(run.steps)
    return 100.0 * work / run.window_s / flops.PEAK_BF16_FLOPS

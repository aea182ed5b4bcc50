"""moe_mfu.train: model FLOPs of the window's steps of the DeepSeek-V3
layout (``bench.flops_moe.model_flops`` from the configuration file's
widths: 6 an active non-embedding parameter and token, the head counted,
plus causal attention; recomputation and the routing's padding not
counted) over the window's time, as a share of the card's bf16 peak."""

from bench import flops, flops_moe


def read(run):
    if not run.steps:
        return None
    work = flops_moe.model_flops(run.cfg, run.rows, run.seq) * len(run.steps)
    return 100.0 * work / run.window_s / flops.PEAK_BF16_FLOPS

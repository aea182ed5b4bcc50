"""mamba2_ssd_roofline.train: K4/K4b's share of their roofline over the
traced window. The calls are the program's counters (``mamba2_ssd_fwd``,
``mamba2_ssd_bwd``), each one layer's scan at the mix's shape; the least
time of a call is ``bench.flops.mamba2_ssd_least_s``; the time is that of
the kernels named below, K4's in ``csrc/mamba2_scan.cu`` and
``scan_common.cuh``."""

from bench import flops

KERNELS = ("ssd_chunk", "chunk_carry", "sum_mid")


def read(run):
    fwd = run.counters.get("mamba2_ssd_fwd", 0)
    bwd = run.counters.get("mamba2_ssd_bwd", 0)
    if run.trace is None or not (fwd or bwd):
        return None
    ns = sum(b - a for name, _, a, b in run.trace.kernels()
             if any(k in name for k in KERNELS))
    if not ns:
        return None
    f, b = flops.mamba2_ssd_least_s(
        run.cfg, run.mix["rows_per_microbatch"], run.seq)
    return 100.0 * (fwd * f + bwd * b) / (ns / 1e9)

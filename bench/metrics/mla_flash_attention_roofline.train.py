"""mla_flash_attention_roofline.train: K3a/K3b's share of their roofline
over the traced window at latent attention's head dims (query/key 192,
value 128). The calls are the program's counters
(``flash_attention_fwd``, ``flash_attention_bwd``), each at the mix's
shape; the least time of a call is
``bench.flops_moe.mla_attention_least_s``; the time is that of the
kernels named below, K3's in ``csrc/flash_attention.cu``."""

from bench import flops_moe

KERNELS = ("fa_fwd", "fa_delta", "fa_dq", "fa_dkv")


def read(run):
    fwd = run.counters.get("flash_attention_fwd", 0)
    bwd = run.counters.get("flash_attention_bwd", 0)
    if run.trace is None or not (fwd or bwd):
        return None
    ns = sum(b - a for name, _, a, b in run.trace.kernels()
             if any(k in name for k in KERNELS))
    if not ns:
        return None
    f, b = flops_moe.mla_attention_least_s(
        run.cfg, run.mix["rows_per_microbatch"], run.seq)
    return 100.0 * (fwd * f + bwd * b) / (ns / 1e9)

"""moe_gmm_roofline.train: K6/K6b's share of their roofline over the
traced window, against the least time of the *routed* rows (a microbatch's
tokens times the experts a token), not of the padded table, so the
padding's waste lowers it. A layer's forward pass is one call of the
program's dropless dispatch (counter ``moe_dispatch``: recomputations
included) and two grouped products; its backward pass two ``gmm_bwd``
calls. The least times are ``bench.flops_moe.moe_gmm_least_s``; the time
is that of the kernels named ``gmm_`` (``csrc/moe_gmm.cu``)."""

from bench import flops_moe


def read(run):
    fwd = run.counters.get("moe_dispatch", 0)
    bwd = run.counters.get("gmm_bwd", 0) / 2
    if run.trace is None or not (fwd or bwd):
        return None
    ns = sum(b - a for name, _, a, b in run.trace.kernels() if "gmm_" in name)
    if not ns:
        return None
    f, b = flops_moe.moe_gmm_least_s(
        run.cfg, run.mix["rows_per_microbatch"], run.seq)
    return 100.0 * (fwd * f + bwd * b) / (ns / 1e9)

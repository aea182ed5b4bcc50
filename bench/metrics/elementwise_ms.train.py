"""elementwise_ms.train: device milliseconds a step in kernels that are
neither matrix products (cuBLAS's and CUTLASS's, by the names below) nor
the port's own kernels (``src/repro_torch/kernels/csrc``): casts, norms,
activations, the optimizer's updates, copies and reductions."""

PRODUCTS = ("gemm", "Gemm", "GEMM", "xmma", "nvjet", "cutlass", "cublas",
            "splitKreduce")
OWN = ("fa_fwd", "fa_delta", "fa_dq", "fa_dkv", "ssd_chunk", "chunk_carry",
       "sum_mid", "wkv_chunk", "gmm_", "decode_split", "decode_merge",
       "decode_ring", "kv_append", "genesys")


def read(run):
    if run.trace is None:
        return None
    kernels = run.trace.kernels()
    if not kernels:
        return None
    ns = sum(b - a for name, _, a, b in kernels
             if not any(p in name for p in PRODUCTS + OWN))
    return ns / 1e6 / len(run.steps)

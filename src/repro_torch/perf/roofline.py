"""Roofline terms of a dry-run cell on H100 constants (the counterpart of
``repro.perf.roofline``).

Hardware constants, per device (NVIDIA H100 SXM data sheet, dense rates
at the 700 W power limit; the same figures as PERF.md section 3):
  peak bf16 compute    989 TFLOP/s
  HBM bandwidth        3.35 TB/s
  NVLink 4             450 GB/s a direction, for a collective whose group
                       lies within one node of 8 GPUs
  network              50 GB/s a direction (one 400 Gb/s NIC per GPU), for
                       a collective whose group spans nodes

Terms (per device; the traced step is each device's own program):
  compute_s    = flops_dev / PEAK_FLOPS
  memory_s     = hbm_bytes_dev / HBM_BW
  collective_s = (wire_bytes_dev - cross_node_wire_bytes_dev) / NVLINK_BW
                 + cross_node_wire_bytes_dev / NIC_BW

Collective bytes follow a ring model per collective (all-reduce 2(g-1)/g,
all-gather and all-to-all (g-1)/g of the result bytes, reduce-scatter
(g-1)x result, collective-permute 1x), the reference's; the raw
result-size sum is also recorded as ``simple_bytes``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NIC_BW = 50e9
NODE_GPUS = 8


def ring_wire_bytes(op: str, nbytes: float, g: int) -> float:
    """Bytes one device moves for collective ``op`` over a group of ``g``
    whose result is ``nbytes`` (the reference's ring model)."""
    if op == "all-reduce":
        return 2 * (g - 1) / g * nbytes
    if op in ("all-gather", "all-to-all"):
        return (g - 1) / g * nbytes
    if op == "reduce-scatter":
        return (g - 1) * nbytes
    return float(nbytes)     # collective-permute


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0            # ring-model bytes per device
    simple_bytes: float = 0.0          # raw result-size sum
    cross_node_wire_bytes: float = 0.0   # the part of groups across nodes
    by_op: dict = field(default_factory=dict)

    def add(self, op: str, nbytes: float, g: int, cross_node: bool) -> None:
        """One collective ``op`` with result ``nbytes`` over ``g``
        devices."""
        wire = ring_wire_bytes(op, nbytes, g)
        self.wire_bytes += wire
        self.simple_bytes += nbytes
        if cross_node:
            self.cross_node_wire_bytes += wire
        d = self.by_op.setdefault(op, {"count": 0, "bytes": 0.0,
                                       "wire": 0.0})
        d["count"] += 1
        d["bytes"] += nbytes
        d["wire"] += wire


@dataclass
class Roofline:
    flops_dev: float
    hbm_bytes_dev: float
    wire_bytes_dev: float
    cross_node_wire_bytes_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float
    useful_flops_ratio: float   # MODEL_FLOPS / (flops_dev * chips)

    def to_dict(self):
        return asdict(self)


def roofline_terms(flops_dev: float, hbm_bytes_dev: float,
                   wire_bytes_dev: float, model_flops_total: float,
                   chips: int, cross_node_wire_bytes_dev: float = 0.0
                   ) -> Roofline:
    c = flops_dev / PEAK_FLOPS
    m = hbm_bytes_dev / HBM_BW
    k = ((wire_bytes_dev - cross_node_wire_bytes_dev) / NVLINK_BW
         + cross_node_wire_bytes_dev / NIC_BW)
    terms = {"compute": c, "memory": m, "collective": k}
    bottleneck = max(terms, key=terms.get)
    ratio = (model_flops_total / (flops_dev * chips)) if flops_dev else 0.0
    return Roofline(flops_dev, hbm_bytes_dev, wire_bytes_dev,
                    cross_node_wire_bytes_dev, c, m, k, bottleneck,
                    model_flops_total, ratio)


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N_active*B per token (decode),
    N_active for MoE."""
    n_active = cfg.active_param_count()
    toks = shape.global_batch * shape.seq_len
    kind = shape.kind.value
    if kind == "train":
        return 6.0 * n_active * toks
    if kind == "prefill":
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq

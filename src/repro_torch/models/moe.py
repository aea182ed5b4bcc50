"""Mixture-of-Experts FFN of the PyTorch port (the counterpart of
``repro.models.moe``): GShard grouped dispatch with a capacity per expert,
one-hot dispatch and combine einsums, and the three expert products as one
grouped matmul each (``ops.gmm``: K6 forward and K6b backward on CUDA
tensors). Beside it, for the DeepSeek-V3 layout of
``port_configs.MlaMoeConfig`` (no counterpart in the JAX package),
:func:`moe_mlp_dropless`: sigmoid routing with a selection bias, every
(token, choice) computed, and shared experts.

moonshot-v1-16b-a3b: 64 experts, top-6.
arctic-480b: 128 experts, top-2, plus a dense residual MLP in parallel.

The reference runs the expert products as einsums over ``[n, E, C, D]``;
here the dispatched rows are laid out ``[E, n C, D]``, one table tile of
n C rows per expert, so the grouped matmul computes the same products
(rows of a dropped or unused capacity slot are zeros and give zeros).
``rules`` adds the reference's sharding constraints (experts on "model",
groups on the batch axes) in that layout. The step keeps fixed shapes and
reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.perf import marks
from repro_torch.sharding import constrain

GROUP_SIZE = 256  # tokens per dispatch group (GShard 'G'), as the reference


def init_moe(pb, cfg):
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.d_ff
    m = pb.sub("moe")
    m.param("router", (D, E), ("embed", "experts"))
    m.param("wi_gate", (E, D, F_), ("experts", "embed", "expert_mlp"))
    m.param("wi_up", (E, D, F_), ("experts", "embed", "expert_mlp"))
    m.param("wo", (E, F_, D), ("experts", "expert_mlp", "embed"))
    if cfg.dense_residual:
        L.init_mlp(pb, cfg, prefix="dense_mlp")


def _capacity(cfg, g: int) -> int:
    c = int(g * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)  # round up to multiple of 4, >=4


def top_k(probs, k: int):
    """The ``k`` largest of ``probs [..., E]`` and their indices, ties to
    the lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class RoutingTap:
    """A tap on the routing of every MoE layer, installed for the span of
    a ``with`` block. One at a time, module-wide (not per thread: the
    serving engine runs its steps on its own threads). ``choose(gate_idx
    [n,g,K])`` may return other top-k choices for the route to take, and
    the route then gates them with its own probabilities; ``routed(gate_idx,
    keep [n,g,K])`` sees the choices taken and whether each fitted under
    its expert's capacity. Either left out changes nothing."""

    def __init__(self, *, choose=None, routed=None):
        self.choose = choose or (lambda gate_idx: gate_idx)
        self.routed = routed or (lambda gate_idx, keep: None)

    def __enter__(self):
        global _tap
        if _tap is not None:
            raise RuntimeError("a routing tap is already installed")
        _tap = self
        return self

    def __exit__(self, *exc):
        global _tap
        _tap = None


_tap: RoutingTap | None = None


class CountDrops(RoutingTap):
    """Counts the token-expert assignments that the capacity dropped, on
    the device: nothing is read back until :meth:`read`."""

    def __init__(self):
        super().__init__(routed=self._count)
        self.dropped = None

    def _count(self, gate_idx, keep):
        n = (~keep).sum()
        self.dropped = n if self.dropped is None else self.dropped + n

    def read(self) -> int:
        return 0 if self.dropped is None else int(self.dropped)


def route(mp, cfg, xg):
    """The reference's routing of xg [n, g, D]: the f32 router softmax,
    the top-k renormalised, and the GShard k-loop's positions (token order
    inside a group, every token's first choice before any second). Returns
    ``(combine [n,g,E,C] float32, gate_idx [n,g,K])``.

    The k-loop is taken in one pass: choice j of token t sits at position
    (its expert's choices < j over the group) + (its expert's choice j
    over the tokens before t), and is kept below the capacity C. A token's
    K choices name K distinct experts, so each (token, expert, slot) of
    ``combine`` holds at most one gate value, exactly the one the loop's
    running sum holds; its slots are filled by one scatter."""
    E, K = cfg.n_experts, cfg.top_k
    n, g, _ = xg.shape
    logits = torch.einsum("ngd,de->nge", xg,
                          mp["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)
    if _tap is not None:
        picked = _tap.choose(gate_idx)
        if picked is not gate_idx:
            gate_idx, gate_vals = picked, probs.gather(-1, picked)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    C = _capacity(cfg, g)
    experts = torch.arange(E, device=xg.device)
    oh = (gate_idx[..., None] == experts).to(torch.int32)       # [n,g,K,E]
    per_choice = oh.sum(dim=1, keepdim=True)                    # [n,1,K,E]
    earlier = torch.cumsum(per_choice, dim=2) - per_choice
    pos = ((torch.cumsum(oh, dim=1) - 1 + earlier) * oh).sum(-1)  # [n,g,K]
    keep = pos < C
    if _tap is not None:
        _tap.routed(gate_idx, keep)
    slot = gate_idx * C + torch.clamp(pos, max=C - 1)
    combine = torch.zeros((n, g, E * C), dtype=torch.float32,
                          device=xg.device).scatter_add(
        2, slot, torch.where(keep, gate_vals, 0.0)).view(n, g, E, C)
    return combine, gate_idx


def expert_rows(gmm, rows, w, tile_expert):
    """The dispatched rows ``[E, n, C, K]`` times each expert's ``w [E, K,
    N]`` -> ``[E, n, C, N]``, through ``gmm(x, w, tile_expert, tile_m)``
    over one table tile of n C rows an expert. A ``gmm`` of
    ``sharding.gmm_on_shards`` takes DTensor rows itself
    (``gmm.on_rows``): each device multiplies its own rows."""
    on_rows = getattr(gmm, "on_rows", None)
    if on_rows is not None and type(rows) is not torch.Tensor:
        return on_rows(rows, w, tile_expert)
    E, n, C, K = rows.shape
    return gmm(L.mergeable(rows, 0, 2).reshape(E * n * C, K), w,
               tile_expert, n * C).view(E, n, C, -1)


def moe_mlp(p, cfg, x, *, gmm=None, rules=None):
    """x [B,S,D] -> [B,S,D]: the MoE output (+ the dense residual MLP).

    ``gmm(x, w, tile_expert, tile_m)`` runs the three expert products
    (:func:`expert_rows`; default ``ops.gmm``, K6/K6b on CUDA tensors;
    ``kernels.moe_gmm.gmm_plain`` is the plain version). A
    :class:`RoutingTap` sees (and may pin) the routing. ``rules``: the
    reference's sharding constraints."""
    dt = x.dtype
    mp = p["moe"]
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    g = min(GROUP_SIZE, T)      # group across ALL tokens (decode: T=B)
    n = T // g
    xg = constrain(x.reshape(n, g, D), rules, "batch", None, "embed")
    combine, _ = route(mp, cfg, xg)
    C = combine.shape[-1]
    dispatch = (combine > 0).to(dt)                        # [n,g,E,C]

    # dispatched rows [E, n, C, D]
    ein = constrain(torch.einsum("ngec,ngd->encd", dispatch, xg), rules,
                    "experts", "batch", None, "embed")
    tile_expert = torch.arange(E, dtype=torch.int32, device=x.device)
    gmm = gmm or ops.gmm
    h_g = expert_rows(gmm, ein, mp["wi_gate"].to(dt), tile_expert)
    h_u = expert_rows(gmm, ein, mp["wi_up"].to(dt), tile_expert)
    h = constrain(F.silu(h_g) * h_u, rules, "experts", "batch", None,
                  "expert_mlp")
    eo = constrain(expert_rows(gmm, h, mp["wo"].to(dt), tile_expert), rules,
                   "experts", "batch", None, "embed")
    # y = sum over (e, c) of combine[n,g,e,c] eo[e,n,c,d], as one product
    # batched over n with e and c merged, e first: DTensor flattens dims
    # only where the first of them carries the sharding (some versions'
    # einsum merged them otherwise)
    y = torch.bmm(combine.to(dt).reshape(n, g, E * C),
                  eo.permute(1, 0, 2, 3).reshape(n, E * C, D))
    y = constrain(y, rules, "batch", None, "embed").reshape(B, S, D)
    if cfg.dense_residual:
        y = y + L.mlp(p["dense_mlp"], x, rules)
    return y


def load_balance_loss(logits_f32, gate_idx, n_experts: int):
    """Standard Switch/GShard auxiliary loss (mean fraction * mean prob),
    the reference's; nothing on its paths calls it."""
    probs = torch.softmax(logits_f32, dim=-1)
    me = probs.reshape(-1, n_experts).mean(dim=0)
    ce = F.one_hot(gate_idx[..., 0].long(), n_experts).float()
    ce = ce.reshape(-1, n_experts).mean(dim=0)
    return n_experts * torch.sum(me * ce)


# ------------------------------------------------- dropless (DeepSeek-V3) ----

TILE_M = 128  # rows of a table tile of the dropless dispatch (K6's tile)


def init_moe_dropless(pb, cfg):
    """The router, the selection bias ``e_score_correction_bias`` (drawn
    normal, std 0.01; it takes part in the choice alone: a leaf of
    ``module.FROZEN``, with no gradient), the routed experts' gate and up
    products as one ``wi [E, D, 2F]`` (gate columns first) and their ``wo
    [E, F, D]``, and the shared experts as one SwiGLU of
    ``n_shared_experts * d_ff`` (``shared``)."""
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.d_ff
    m = pb.sub("moe")
    m.param("router", (D, E), ("embed", "experts"))
    m.param("e_score_correction_bias", (E,), ("experts",), scale=0.01)
    m.param("wi", (E, D, 2 * F_), ("experts", "embed", "expert_mlp"))
    m.param("wo", (E, F_, D), ("experts", "expert_mlp", "embed"))
    L.init_mlp(pb, dataclasses.replace(cfg, d_ff=cfg.shared_d_ff,
                                       mlp_kind="swiglu"), prefix="shared")


def route_sigmoid(mp, cfg, x):
    """DeepSeek-V3's ``noaux_tc`` routing of ``x [T, D]`` (one group):
    float32 scores s = sigmoid(x W_r), the ``top_k`` experts of s + b
    (b the selection bias; ties to the lower index), weighted by s,
    normalised to sum 1 and scaled by ``routed_scaling``. Returns ``(gates
    [T, K] float32, idx [T, K])``; the gates carry the router's gradient,
    the choice none."""
    s = torch.sigmoid(x.float() @ mp["router"].float())
    _, idx = top_k(s.detach() + mp["e_score_correction_bias"].detach()
                   .float(), cfg.top_k)
    gates = s.gather(-1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * cfg.routed_scaling, idx


class RoutedRows:
    """The rows each expert of each MoE layer got, summed on the device
    over every dropless dispatch since :meth:`reset` (a layer's
    recomputation under remat counts again, which moves no share):
    nothing is read back until :meth:`read`."""

    def __init__(self):
        self.counts: dict = {}

    def add(self, layer: int, routed) -> None:
        got = self.counts.get(layer)
        self.counts[layer] = routed if got is None else got + routed

    def reset(self) -> None:
        self.counts = {}

    def read(self) -> dict:
        """``{layer: [rows an expert]}``."""
        return {k: v.tolist() for k, v in sorted(self.counts.items())}


ROUTED = RoutedRows()


def moe_mlp_dropless(p, cfg, x, *, gmm=None, layer: int = 0):
    """x [B,S,D] -> [B,S,D]: the routed experts' output, every (token,
    choice) computed, plus the shared experts'. Routing
    (:func:`route_sigmoid`) and the sort into a table of whole tiles
    (``ops.moe_dispatch``) run in the span ``moe_dispatch``; the gate and
    up products as one grouped matmul of N = 2F, SiLU(gate) times up, and
    the down product run on ``gmm`` over the table (default ``ops.gmm``,
    K6/K6b on CUDA tensors; ``kernels.moe_gmm.gmm_plain`` is the plain
    version); the rows back in token order, weighted (``ops.moe_combine``),
    in the span ``moe_combine``. The spans are children of the thread's
    open one (``perf.marks``) with device marks on a card. ``layer``
    indexes :data:`ROUTED`'s counts."""
    dt, mp = x.dtype, p["moe"]
    B, S, D = x.shape
    F_ = cfg.d_ff
    cuda = x.device.type == "cuda"
    x2 = x.reshape(B * S, D)
    with marks.here("moe_dispatch", cuda):
        gates, idx = route_sigmoid(mp, cfg, x2)
        table, tile_expert, slot, routed = ops.moe_dispatch(
            x2, idx, n_experts=cfg.n_experts, tile_m=TILE_M)
    ROUTED.add(layer, routed)
    gmm = gmm or ops.gmm
    h = gmm(table, mp["wi"].to(dt), tile_expert, TILE_M)
    h = F.silu(h[:, :F_]) * h[:, F_:]
    rows = gmm(h, mp["wo"].to(dt), tile_expert, TILE_M)
    with marks.here("moe_combine", cuda):
        y = ops.moe_combine(rows, slot, gates)
    return y.view(B, S, D) + L.mlp(p["shared"], x)

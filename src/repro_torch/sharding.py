"""Logical-axis sharding rules of the PyTorch port (the counterpart of
``repro.sharding``), mapped onto a ``torch.distributed`` DeviceMesh whose
dims are named "pod", "data" and "model".

Conventions (the reference's):
  batch        -> ("pod", "data")   data parallel, pods compose with data
  vocab        -> "model"           tensor-parallel embedding / lm head
  heads        -> "model"           attention-head tensor parallelism
  kv_heads     -> "model" iff divisible, else shard head_dim ("kv_alt")
  mlp          -> "model"           FFN tensor parallelism
  experts      -> "model"           expert parallelism (all-to-all dispatch)
  embed/seq    -> None              replicated (seq-parallel is a perf knob)
  fsdp axes    -> "data"            ZeRO-style storage sharding (opt-in)

A spec is a tuple with one entry per tensor dim: a mesh dim's name, a
tuple of them, or None (JAX's ``PartitionSpec``). :func:`placements`
turns it into DTensor placements, one per mesh dim: ``Shard(i)`` on every
mesh dim that names tensor dim ``i``, ``Replicate()`` elsewhere. A tensor
dim over several mesh dims is split major to minor in the mesh's own dim
order, as JAX splits it; a spec that names them in another order has no
DTensor placement and is refused.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

BATCH_AXES = ("pod", "data")


def kv_repeat(cfg, model_size: int) -> int:
    """Megatron-style KV replication factor: repeat each KV head r times so
    KV*r == TP degree, provided the GQA group splits evenly (G % r == 0).
    Cleans up attention sharding when kv_heads < model_size."""
    kv, h = cfg.n_kv_heads, cfg.n_heads
    if not kv or kv >= model_size or model_size % kv != 0:
        return 1
    r = model_size // kv
    g = h // kv
    return r if g % r == 0 else 1


def mesh_sizes(mesh) -> dict:
    """{mesh dim name: size} of a DeviceMesh (JAX's ``mesh.shape``); {} for
    no mesh."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class ShardingRules:
    """logical name -> mesh dim (or tuple of mesh dims, or None)."""
    kv_rep: int = 1
    mesh: Any = None          # a torch.distributed DeviceMesh, or None
    rules: dict = field(default_factory=lambda: dict(
        batch=BATCH_AXES,
        seq=None,
        embed=None,
        vocab="model",
        heads="model",
        kv_heads="model",
        kv_head_dim=None,     # used when kv_heads don't divide |model|
        head_dim=None,
        mlp="model",
        heads_flat="model",   # rwkv: fused H*hd projections
        embed2=None,          # square D->D projections, output side
        experts="model",
        expert_mlp=None,
        ssm_inner="model",
        ssm_state=None,
        conv=None,
        fsdp=None,            # set to "data" for ZeRO storage sharding
        stack=None,           # stacked layer dim
    ))

    def axis(self, name: str | None):
        if name is None:
            return None
        if name not in self.rules:
            raise KeyError(f"unknown logical axis {name!r}")
        return self.rules[name]

    def spec(self, *names: str | None) -> tuple:
        return tuple(self.axis(n) for n in names)

    def with_overrides(self, **kv) -> "ShardingRules":
        return ShardingRules(kv_rep=self.kv_rep, mesh=self.mesh,
                             rules={**self.rules, **kv})

    def with_kv_rep(self, r: int) -> "ShardingRules":
        return ShardingRules(kv_rep=r, mesh=self.mesh, rules=dict(self.rules))

    def with_mesh(self, mesh) -> "ShardingRules":
        return ShardingRules(kv_rep=self.kv_rep, mesh=mesh,
                             rules=dict(self.rules))


def rules_for(cfg, mesh, *, fsdp: bool = False) -> ShardingRules:
    """Per-arch rules: resolve kv-head replication and FSDP storage.

    GQA archs whose kv_heads don't divide the TP degree either replicate KV
    heads (kv_repeat) or fall back to head_dim sharding."""
    sizes = mesh_sizes(mesh)
    r = ShardingRules().with_mesh(mesh)
    batch_axes = tuple(a for a in BATCH_AXES if a in sizes)
    r = r.with_overrides(batch=batch_axes or None)
    model_size = sizes.get("model", 1)
    if cfg.n_kv_heads:
        rep = kv_repeat(cfg, model_size)
        r = r.with_kv_rep(rep)
        if (cfg.n_kv_heads * rep) % model_size != 0:
            # GQA that can't replicate to TP degree: shard head_dim instead
            r = r.with_overrides(kv_heads=None, kv_head_dim="model")
        if cfg.n_heads % model_size != 0:
            # uneven q heads (36/56 vs 16): shard head_dim for all of QKV
            r = r.with_overrides(heads=None, head_dim="model",
                                 kv_heads=None, kv_head_dim="model")
    if cfg.family.value in ("ssm", "hybrid"):
        if cfg.ssm_state and (cfg.d_inner // cfg.ssm_head_dim) % model_size:
            r = r.with_overrides(ssm_inner=None)
    if fsdp:
        r = r.with_overrides(fsdp="data")
    return r


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def fit_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop sharding on dims the mesh axis size doesn't divide (shards must
    divide evenly; intermediates also propagate cleaner)."""
    sizes = mesh_sizes(mesh)
    out = []
    for i, axis in enumerate(spec):
        if i >= len(shape):
            out.append(None)
            continue
        size = _axis_size(sizes, axis)
        out.append(axis if size > 1 and shape[i] % size == 0
                   else (axis if size == 1 else None))
    return tuple(out)


# logical dims eligible for ZeRO/FSDP storage sharding over the data axes
FSDP_CANDIDATES = ("embed", "mlp", "expert_mlp", "vocab", "heads",
                   "head_dim", "kv_heads", "kv_head_dim", "ssm_inner",
                   "heads_flat", "embed2", "experts")


def apply_fsdp(spec: tuple, names, shape, mesh, fsdp_axes) -> tuple:
    """Shard the largest currently-unsharded eligible dim over the data
    axes (ZeRO-style parameter/optimizer storage sharding)."""
    if len(shape) < 2:
        return spec
    ways = _axis_size(mesh_sizes(mesh), tuple(fsdp_axes))
    best, best_size = None, 0
    for i, name in enumerate(names):
        if i >= len(shape) or spec[i] is not None:
            continue
        if name in FSDP_CANDIDATES and shape[i] % ways == 0 \
                and shape[i] > best_size:
            best, best_size = i, shape[i]
    if best is None:
        return spec
    out = list(spec)
    out[best] = tuple(fsdp_axes)
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(i)`` where the mesh dim names tensor dim ``i`` and has more
    than one device, else ``Replicate()``. Raises ValueError for a mesh
    dim the mesh lacks, one named twice, or a tuple out of the mesh's
    major-to-minor order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out = [Replicate()] * len(names)
    seen = set()
    for i, axis in enumerate(spec):
        if axis is None:
            continue
        group = axis if isinstance(axis, tuple) else (axis,)
        dims = []
        for a in group:
            if a not in names:
                raise ValueError(f"spec {spec} names mesh dim {a!r}; the "
                                 f"mesh has {names}")
            dims.append(names.index(a))
        if dims != sorted(dims):
            raise ValueError(f"spec {spec} splits dim {i} over {group}, "
                             f"not in the mesh's order {names}")
        for d in dims:
            if d in seen:
                raise ValueError(f"spec {spec} names mesh dim "
                                 f"{names[d]!r} twice")
            seen.add(d)
            if sizes[names[d]] > 1:
                out[d] = Shard(i)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        """One device's shard of a tensor of ``shape`` (every sharded dim
        divides: :func:`fit_spec`)."""
        sizes = mesh_sizes(self.mesh)
        out = []
        for i, n in enumerate(shape):
            ways = _axis_size(sizes, self.spec[i]) if i < len(self.spec) \
                else 1
            if n % ways:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"{ways} ways ({self.spec})")
            out.append(n // ways)
        return tuple(out)


def named_sharding(mesh, rules: ShardingRules, *names,
                   shape=None, fsdp_axes=None) -> NamedSharding:
    spec = rules.spec(*names)
    if shape is not None:
        spec = fit_spec(spec, shape, mesh)
        if fsdp_axes:
            spec = apply_fsdp(spec, names, shape, mesh, fsdp_axes)
    return NamedSharding(mesh, spec)


def constrain(x, rules: ShardingRules | None, *names):
    """The reference's ``with_sharding_constraint`` by logical names: a
    DTensor on a mesh of more than one device is redistributed to the
    spec fitted to its shape; anything else (no rules, no mesh, one
    device, a plain tensor) is returned as it is."""
    if rules is None or rules.mesh is None or rules.mesh.size() == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = fit_spec(rules.spec(*names), x.shape, rules.mesh)
    return x.redistribute(rules.mesh, placements(spec, rules.mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(n, (str, type(None)))
                                        for n in x)


def tree_shardings(mesh, rules: ShardingRules, logical_tree,
                   shapes_tree=None, fsdp_axes=None):
    """Map a tree (nested dicts) of logical-name tuples to NamedShardings;
    if a parallel tree of tensors is given, fit each spec to the leaf's
    shape (and optionally apply FSDP storage sharding over
    ``fsdp_axes``)."""
    if _is_axes(logical_tree):
        if shapes_tree is None:
            return named_sharding(mesh, rules, *logical_tree)
        return named_sharding(mesh, rules, *logical_tree,
                              shape=tuple(shapes_tree.shape),
                              fsdp_axes=fsdp_axes)
    return {k: tree_shardings(mesh, rules, v,
                              None if shapes_tree is None else shapes_tree[k],
                              fsdp_axes)
            for k, v in logical_tree.items()}


def splittable(t, dim: int, parts: int):
    """``t`` ready for its dim ``dim`` to be split into ``parts`` parts
    of equal size (heads out of a fused projection, groups of rows). A
    plain tensor is returned as it is. A DTensor whose shards on that dim
    do not hold whole parts (the dim's mesh ways do not divide ``parts``)
    is gathered on it first: DTensor cannot unflatten an uneven split, nor
    hand a device a share of a part."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    dim = dim % t.dim()
    ways = math.prod(t.device_mesh.size(i)
                     for i, p in enumerate(t.placements) if p == Shard(dim))
    if parts % ways == 0:
        return t
    keep = [Replicate() if p == Shard(dim) else p for p in t.placements]
    return t.redistribute(t.device_mesh, keep)


# on_shards' (head_dims, batch_dims, out_dims) of the scans: the SSD scan
# (ops.mamba2_ssd, kernels.mamba2_scan.ssd_chunked_plain) of x [B,L,H,P],
# dt [B,L,H], A [H], Bm, Cm [B,L,N] -> (y [B,L,H,P], s_final [B,H,N,P]),
# and the WKV (ops.rwkv6_wkv, kernels.rwkv6_scan.wkv6_chunked_plain) of
# r, k, v, w [B,L,H,hd], u [H,hd] -> (o [B,L,H,hd], s_final [B,H,hd,hd])
SSD_DIMS = ((2, 2, 0, None, None), (0, 0, None, 0, 0), ((0, 2), (0, 1)))
WKV_DIMS = ((2, 2, 2, 2, 0), (0, 0, 0, 0, None), ((0, 2), (0, 1)))


def on_shards(fn, head_dims, batch_dims=None, out_dims=None):
    """``fn`` run on each device's shards of its tensor arguments: an
    attention or a scan, where a batch row's and a head's output needs only
    that row and head. ``head_dims[i]`` and ``batch_dims[i]`` name argument
    ``i``'s head and batch dims (None for one it has not: ``A [H]`` has no
    batch dim, ``Bm [B,L,N]`` no head dim; ``batch_dims`` defaults to dim 0
    of every argument). On each mesh dim the arguments keep a batch
    sharding or a head sharding that none of them contradicts (a
    replicated argument is cut to match; one without that dim stays
    whole, and its gradient from each device's shards is a partial sum
    over them); everything else is gathered first. A plain tensor argument
    counts as replicated. ``out_dims``: None for one result, which takes
    the first argument's shape and placements; else one ``(batch_dim,
    head_dim)`` per element of a tuple result, each placed by its own
    dims, with the first batched argument's global batch and the first
    argument's global heads. Without DTensors, ``fn`` runs as it is."""
    batch_dims = (0,) * len(head_dims) if batch_dims is None else batch_dims

    def run(*args, **kwargs):
        import torch
        from torch.distributed.tensor import (
            DTensor, Partial, Replicate, Shard,
        )
        if not isinstance(args[0], DTensor):
            return fn(*args, **kwargs)
        mesh = args[0].device_mesh
        args = [a if isinstance(a, DTensor) or not isinstance(
                    a, torch.Tensor)
                else DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                        run_check=False)
                for a in args]
        dts = [(batch_dims[i], head_dims[i], a) for i, a in enumerate(args)
               if isinstance(a, DTensor)]

        def kind(p, bd, hd):    # what a placement says of one argument
            if p == Replicate():
                return "any"
            return ("batch" if bd is not None and p == Shard(bd)
                    else "heads" if hd is not None and p == Shard(hd)
                    else None)
        keep = []
        for m in range(mesh.ndim):
            kinds = {kind(a.placements[m], bd, hd) for bd, hd, a in dts}
            keep.append(next(iter(kinds - {"any"}))
                        if len(kinds - {"any"}) == 1 and None not in kinds
                        else None)

        def placements(bd, hd):
            return [Shard(bd) if k == "batch" and bd is not None
                    else Shard(hd) if k == "heads" and hd is not None
                    else Replicate() for k in keep]

        def local(a, bd, hd):
            pl = placements(bd, hd)
            # whole on a mesh dim whose shards split the work: each
            # device's gradient of it is its share of the sum
            grad = [Partial() if p == Replicate() and k is not None else p
                    for p, k in zip(pl, keep)]
            return a.redistribute(mesh, pl).to_local(grad_placements=grad)
        local = [local(a, batch_dims[i], head_dims[i])
                 if isinstance(a, DTensor) else a
                 for i, a in enumerate(args)]
        out = fn(*local, **kwargs)
        if out_dims is None:
            q = args[0]
            return DTensor.from_local(
                out, mesh, placements(batch_dims[0], head_dims[0]),
                run_check=False, shape=q.shape,
                stride=torch.empty(q.shape, device="meta").stride())
        batch = next(a.shape[bd] for bd, _, a in dts if bd is not None)
        heads = (None if head_dims[0] is None
                 else args[0].shape[head_dims[0]])

        def place(t, bd, hd):
            # the DTensor's strides are the contiguous ones of its shape:
            # so must the shard's be (the plain scans return permuted views)
            t = t.contiguous()
            shape = list(t.shape)
            if bd is not None:
                shape[bd] = batch
            if hd is not None:
                shape[hd] = heads
            return DTensor.from_local(
                t, mesh, placements(bd, hd), run_check=False,
                shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
        return tuple(place(t, bd, hd) for t, (bd, hd) in zip(out, out_dims))
    return run


def gmm_on_shards(gmm):
    """The grouped matmul ``gmm(x, w, tile_expert, tile_m)`` (``ops.gmm``),
    as it is for plain tensors, with ``on_rows(rows, w, tile_expert)`` for
    ``models.moe.expert_rows``: the dispatched rows ``[E, n, C, K]`` (a
    DTensor) times each expert's ``w [E, K, N]`` on each device's own
    groups n, through :func:`on_shards` (``w`` whole, its gradient a
    partial sum where the groups are split). Where the groups do not
    divide over the mesh dims that split them, the rows are gathered
    first and every device multiplies them all. Routing, dispatch and
    combine stay on the DTensors: the groups, capacities and drops are
    the one-process step's."""
    def by_rows(rows, w, tile_expert):
        E, n, C, K = rows.shape
        return (gmm(rows.reshape(E * n * C, K), w, tile_expert,
                    n * C).view(E, n, C, -1),)
    sharded = on_shards(by_rows, (None, None, None), (1, None, None),
                        ((1, None),))

    def on_rows(rows, w, tile_expert):
        return sharded(splittable(rows, 1, rows.shape[1]), w,
                       tile_expert)[0]

    def run(*args, **kwargs):
        return gmm(*args, **kwargs)
    run.on_rows = on_rows
    return run

"""AdamW with global-norm clipping (the counterpart of
``repro.optim.adamw``), over the port's nested dicts of tensors.

The arithmetic is the reference's: gradients scaled by
``min(1, grad_clip / max(gnorm, 1e-9))``, f32 moments ``m = b1 m + (1-b1)
g`` and ``v = b2 v + (1-b2) g^2``, bias correction by ``1 - b**count``
with an int32 ``count``, and weight decay added to the step (not to the
gradient): ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
``moments_dtype="bfloat16"`` stores the moments in bf16 and computes in
f32, as the reference does. ``microbatches`` says how many microbatches'
gradients the update gets summed: it divides them by that count first
(the reference's train step takes their mean).

Unlike the reference, :meth:`AdamW.update` works IN PLACE: the largest
leaf of a full-width model is gigabytes (starcoder2-7b's stacked
``mlp/wi_up`` at 8 layers: 2.7 GB in f32), and the reference's
per-leaf expression would hold about six such temporaries at once.
Parameters, moments and ``count`` are updated in place and returned. The
state never leaves the device, so the update does not wait on the host.

Two routes, chosen by what the leaves are. Where ``kernels.adamw.refusal``
finds no reason to refuse them (plain float32 CUDA tensors, contiguous and
16-byte aligned, parameters, gradients and moments alike, with the count
on their device), the update takes the hand-written kernels
(``kernels.adamw``: one pass for the norm, one for the update, 32 bytes a
parameter; the gradients are only read). Everything else (CPU tensors,
DTensors, whose norm crosses ranks, bf16 moments) takes
:meth:`AdamW.update_plain`, eager PyTorch with at most one leaf-sized
temporary at a time, which divides and scales the gradients in place
(they are spent). ``AdamW.fused_leaves`` and ``AdamW.plain_leaves`` count
the leaves each route has updated in this process.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar

import torch

from repro_torch.kernels.adamw import adamw_sqnorm, adamw_update, refusal


@dataclass
class OptState:
    m: Any
    v: Any
    count: torch.Tensor      # 0-d int32


def leaves(tree) -> list:
    """The tensors of a tree of dicts and OptStates in
    ``jax.tree_util.tree_flatten`` order: dict keys sorted, an OptState
    as (m, v, count). Checkpoints store their leaves in this order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, OptState):
        return leaves(tree.m) + leaves(tree.v) + [tree.count]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf^2), in f32 (0-d tensor)."""
    return _norm(leaves(tree))


def _norm(ts) -> torch.Tensor:
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32) ** 2 for t in ts]
    return torch.sqrt(torch.stack(sq).sum())


def _stepped(grads, state, params):
    """The leaves the update steps, as lists ``(gs, ms, vs, ps)``: those
    with a gradient. A leaf without one is left as it is where its
    parameter requires none (a frozen leaf, ``models.module.FROZEN``);
    where it requires one, the parameter was cut off from the loss, and
    that raises."""
    gs, ms, vs, ps = (leaves(t) for t in (grads, state.m, state.v, params))
    keep = []
    for i, (g, p) in enumerate(zip(gs, ps)):
        if g is not None:
            keep.append(i)
        elif p.requires_grad:
            raise ValueError(f"parameter leaf {i} {tuple(p.shape)} "
                             f"requires a gradient and got none")
    return tuple([t[i] for i in keep] for t in (gs, ms, vs, ps))


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: str = "float32"
    microbatches: int = 1
    # leaves updated by each route, in this process
    fused_leaves: ClassVar[int] = 0
    plain_leaves: ClassVar[int] = 0

    def init(self, params) -> OptState:
        dt = getattr(torch, self.moments_dtype)

        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            # zeros_like keeps a DTensor parameter's mesh and placements
            return torch.zeros_like(tree, dtype=dt,
                                    memory_format=torch.contiguous_format)
        first = leaves(params)[0]
        return OptState(m=zeros(params), v=zeros(params),
                        count=torch.zeros((), dtype=torch.int32,
                                          device=first.device))

    def state_axes(self, param_axes) -> OptState:
        """Logical axes for the state: the moments follow the
        parameters."""
        return OptState(m=param_axes, v=param_axes, count=())

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """One step: ``(params, state, gnorm)``, params and state updated
        in place (see the module docstring). ``gnorm`` is the global norm
        of the gradients divided by ``microbatches``. A frozen leaf
        (no gradient, and its parameter requires none) is left as it is:
        no decay, no moments."""
        gs, ms, vs, ps = _stepped(grads, state, params)
        if refusal((ps, gs, ms, vs), state.count) is not None:
            AdamW.plain_leaves += len(ps)
            return self.update_plain(grads, state, params)
        AdamW.fused_leaves += len(ps)
        gnorm = adamw_sqnorm(gs, self.microbatches)
        adamw_update(ps, gs, ms, vs, state.count, gnorm, lr=self.lr,
                     beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                     weight_decay=self.weight_decay, grad_clip=self.grad_clip,
                     divisor=self.microbatches)
        return params, state, gnorm

    @torch.no_grad()
    def update_plain(self, grads, state: OptState, params):
        """:meth:`update` in eager PyTorch, on any leaves: at most one
        leaf-sized temporary at a time; the gradients are divided and
        scaled in place."""
        gs, ms, vs, ps = _stepped(grads, state, params)
        if self.microbatches > 1:
            for g in gs:
                g.div_(self.microbatches)
        state.count.add_(1)
        gnorm = _norm(gs)
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        b1, b2 = self.beta1, self.beta2
        cnt = state.count.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, device=cnt.device), cnt)
        c2 = 1.0 - torch.pow(torch.tensor(b2, device=cnt.device), cnt)
        for g, m, v, p in zip(gs, ms, vs, ps):
            g = g.float() if g.dtype != torch.float32 else g
            g.mul_(scale)
            mf = m if m.dtype == torch.float32 else m.float()
            vf = v if v.dtype == torch.float32 else v.float()
            mf.mul_(b1).add_(g, alpha=1 - b1)
            vf.mul_(b2).addcmul_(g, g, value=1 - b2)
            # the one leaf-sized temporary: sqrt(v_hat) + eps, then the step
            step = torch.div(vf, c2).sqrt_().add_(self.eps)
            torch.div(mf, step, out=step).div_(c1)
            pf = p if p.dtype == torch.float32 else p.float()
            step.add_(pf, alpha=self.weight_decay)
            pf.add_(step, alpha=-self.lr)
            for low, f32 in ((m, mf), (v, vf), (p, pf)):
                if low is not f32:
                    low.copy_(f32)
        return params, state, gnorm


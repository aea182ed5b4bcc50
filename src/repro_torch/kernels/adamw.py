"""The optimizer's step as hand-written CUDA kernels (``csrc/adamw.cu``):
AdamW with global-norm clipping over a table of f32 leaves, updated in
place, beside its plain PyTorch version.

The reference's update (``repro.optim.adamw.AdamW.update``) is one XLA
fusion a leaf under ``jit``; eager PyTorch runs it as ~14 passes a leaf.
The kernels move 32 bytes a parameter: :func:`adamw_sqnorm` reads the
gradients once for the global norm, :func:`adamw_update` reads g, m, v and
p once and writes m, v and p once. Both take the whole table in one
launch (64 leaves a launch), read the count and the norm on the device, and
copy nothing from the host, so the host never waits on the stream inside
the optimizer. They allocate only the norm's partial sums (``blocks``
floats) and the norm itself.

* :func:`adamw_sqnorm_plain` and :func:`adamw_update_plain` are the
  kernels' arithmetic in PyTorch, leaf after leaf in table order: ``g = g /
  divisor * scale``, ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
  ``d = m / (sqrt(v / c2) + eps) / c1 + wd p``, ``p -= lr d``, with ``c =
  count + 1``, ``c1 = 1 - b1^c``, ``c2 = 1 - b2^c`` and ``scale = min(1,
  clip / max(gnorm, 1e-9))``; then ``count += 1``. The divisor is the
  microbatches' count: the gradients hold their sum.
* :func:`adamw_sqnorm` and :func:`adamw_update` launch the kernels. They
  take what :func:`refusal` finds no reason to refuse (plain float32 CUDA
  tensors, contiguous and 16-byte aligned, with the count and the norm on
  their device) and raise with its reason on anything else; the same rule
  picks ``AdamW.update``'s route. ``adamw_sqnorm.launches`` and
  ``adamw_update.launches`` count their launches.

The kernels round as the plain version does, operation by operation (IEEE
division and square root); they differ from it in the norm's summation
order, and so in the last bits of the clip scale where clipping engages.
Two calls on one card give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# blocks a streaming multiprocessor: the kernels' launch bounds
# (``__launch_bounds__(256, 4)`` in csrc/adamw.cu) keep four resident
BLOCKS_PER_SM = 4


def adamw_sqnorm_plain(gs, divisor: float = 1):
    """The global norm of the gradients ``gs``, each divided by
    ``divisor``: sqrt of the sum over leaves of sum((g / divisor)^2), in
    float32 (0-d)."""
    total = torch.zeros((), dtype=torch.float32, device=gs[0].device)
    for g in gs:
        x = g / divisor
        total = total + torch.sum(x * x)
    return torch.sqrt(total)


def adamw_update_plain(ps, gs, ms, vs, count, gnorm, *, lr: float,
                       beta1: float, beta2: float, eps: float,
                       weight_decay: float, grad_clip: float,
                       divisor: float = 1) -> None:
    """One AdamW step over the leaves ``ps`` (parameters), ``gs``
    (gradients, only read), ``ms`` and ``vs`` (moments), in place, and
    ``count += 1``: the module docstring's arithmetic, ``gnorm`` being
    :func:`adamw_sqnorm_plain`'s."""
    c = count.float() + 1
    c1 = 1.0 - torch.full_like(c, beta1).pow_(c)
    c2 = 1.0 - torch.full_like(c, beta2).pow_(c)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    for p, g, m, v in zip(ps, gs, ms, vs):
        g = g / divisor * scale
        m.mul_(beta1).add_(g, alpha=1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        d = torch.div(v, c2).sqrt_().add_(eps)
        torch.div(m, d, out=d).div_(c1).add_(p, alpha=weight_decay)
        p.add_(d, alpha=-lr)
    count.add_(1)


def refusal(tables, count=None, gnorm=None):
    """Why the kernels do not take the leaf tables ``tables`` (lists of
    tensors, a leaf's tensors at one index), the step ``count`` and the
    norm ``gnorm`` (either may be None), or None where they do: plain
    ``torch.Tensor`` leaves (not DTensors), float32, contiguous, 16-byte
    aligned and on one CUDA device, of one shape a leaf, with a 0-d int32
    ``count`` and a 0-d float32 ``gnorm`` there. ``AdamW.update`` takes
    the kernels where this is None; the wrappers raise with it."""
    n = len(tables[0])
    if n == 0 or any(len(t) != n for t in tables):
        return (f"the leaf tables must be non-empty and of one length, got "
                f"{[len(t) for t in tables]}")
    dev = tables[0][0].device
    for leaf in zip(*tables):
        for t in leaf:
            if type(t) is not torch.Tensor:
                return (f"the kernels take plain tensors, not "
                        f"{type(t).__name__}")
            if t.dtype != torch.float32:
                return f"every leaf must be float32, got {t.dtype}"
            if not t.is_contiguous() or t.data_ptr() % 16:
                return "every leaf must be contiguous and 16-byte aligned"
            if t.shape != leaf[0].shape:
                return (f"a leaf's tensors differ in shape: "
                        f"{[tuple(x.shape) for x in leaf]}")
            if t.device != dev:
                return f"the leaves lie on {dev} and {t.device}"
    for t, dtype, what in ((count, torch.int32, "count"),
                           (gnorm, torch.float32, "gnorm")):
        if t is not None and (type(t) is not torch.Tensor or t.shape != ()
                              or t.dtype != dtype or t.device != dev):
            return (f"{what} must be a 0-d {dtype} tensor on {dev}, got "
                    f"{type(t).__name__} {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
    if dev.type != "cuda":
        return f"the kernels run on a CUDA device, not {dev}"
    return None


def _refuse(what: str, *args, **kwargs) -> None:
    why = refusal(*args, **kwargs)
    if why is not None:
        raise ValueError(f"{what}: {why}")


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _sizes(tensors):
    return (ctypes.c_longlong * len(tensors))(*(t.numel() for t in tensors))


def _blocks(device) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        device).multi_processor_count


def adamw_sqnorm(gs, divisor: float = 1):
    """The kernels' :func:`adamw_sqnorm_plain` (0-d float32 on the
    gradients' device); raises where :func:`refusal` names a reason."""
    _refuse("adamw_sqnorm", (gs,))
    dev = gs[0].device
    blocks = _blocks(dev)
    partials = torch.empty(blocks, dtype=torch.float32, device=dev)
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adamw_sqnorm_launch(
            _pointers(gs), _sizes(gs), len(gs), float(divisor),
            partials.data_ptr(), blocks, gnorm.data_ptr(), stream)
    _build.check(err, "adamw_sqnorm")
    adamw_sqnorm.launches += 1
    return gnorm


adamw_sqnorm.launches = 0


def adamw_update(ps, gs, ms, vs, count, gnorm, *, lr: float, beta1: float,
                 beta2: float, eps: float, weight_decay: float,
                 grad_clip: float, divisor: float = 1) -> None:
    """The kernels' :func:`adamw_update_plain`: one launch of the update
    over the table (then ``count += 1``); raises where :func:`refusal`
    names a reason. ``gnorm`` is :func:`adamw_sqnorm`'s."""
    _refuse("adamw_update", (ps, gs, ms, vs), count, gnorm)
    dev = ps[0].device
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adamw_update_launch(
            _pointers(ps), _pointers(gs), _pointers(ms), _pointers(vs),
            _sizes(ps), len(ps), gnorm.data_ptr(), count.data_ptr(), beta1,
            1 - beta1, beta2, 1 - beta2, eps, weight_decay, -lr, grad_clip,
            float(divisor), _blocks(dev), stream)
    _build.check(err, "adamw_update")
    adamw_update.launches += 1


adamw_update.launches = 0

"""Step builders of the PyTorch port (the counterpart of
``repro.train.steps``): the train step, the prefill step, the paged serve
step and the dense-cache serve step, each over the family's model from
``models.registry``.

Batch dict convention (the reference's):
  tokens  [B, S_text] int32        (always)
  labels  [B, S_text] int32        (train; -100 = masked)
  embeds  [B, P, D]   compute_dtype (vlm patch / audio frame stub, optional;
                                     the encoder-decoder's frames)
"""
from __future__ import annotations

import torch

from repro_torch import port_configs
from repro_torch.config import Family, ModelConfig, TrainConfig
from repro_torch.core.genesys.trace import current_recorder
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.module import FROZEN
from repro_torch.models.registry import get_api
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import leaves
from repro_torch.perf import marks
from repro_torch.sharding import constrain

IGNORE = -100


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """logits [B,S,V] f32; labels [B,S] with IGNORE masking. Returns
    ``(loss, nll)``: the mean over unmasked positions of nll + z_loss *
    lse^2, and of nll alone."""
    mask = labels != IGNORE
    labels_safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    if type(logits) is torch.Tensor:
        gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    else:
        # a DTensor, its vocabulary perhaps split: the gold logit as a
        # masked sum (the same value), which DTensor sums across the split
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.where(vocab == labels_safe[..., None], logits,
                           0.0).sum(-1)
    nll = (lse - gold) * mask
    zl = z_loss * torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1)
    return (nll + zl).sum() / denom, nll.sum() / denom


def _call_forward(params, cfg: ModelConfig, batch, kernels, rules):
    """The family's no-cache forward over a batch: the encoder-decoder
    takes ``embeds`` as its frames, the other families as a prefix."""
    forward = get_api(cfg).forward
    if cfg.family == Family.ENCDEC:
        return forward(params, cfg, batch["tokens"],
                       frames=batch.get("embeds"), kernels=kernels,
                       rules=rules)
    return forward(params, cfg, batch["tokens"], embeds=batch.get("embeds"),
                   kernels=kernels, rules=rules)


def loss_fn(params, cfg: ModelConfig, batch, tc: TrainConfig,
            kernels: ops.Kernels = ops.KERNELS, rules=None):
    """The no-cache forward and :func:`cross_entropy` over the text
    positions (a VLM's logits over its patch prefix are dropped). Returns
    ``(loss, {"nll": nll})``."""
    logits, _ = _call_forward(params, cfg, batch, kernels, rules)
    if cfg.family == Family.VLM and batch.get("embeds") is not None:
        logits = logits[:, batch["embeds"].shape[1]:]
    loss, nll = cross_entropy(logits, batch["labels"], tc.z_loss)
    return loss, {"nll": nll}


def _phase(rec, name: str, cuda: bool):
    """The step's span ``name`` under the thread's open one (the
    Trainer's ``step``), with device marks on a card; nothing where no
    span is open."""
    return marks.span(rec, name, cuda)


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    kernels: ops.Kernels = ops.KERNELS, *, rules=None):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` with ``loss``, ``grad_norm`` and
    ``nll`` as 0-d tensors.

    ``tc.microbatches > 1`` splits the batch's rows into that many
    microbatches (the reference's ``lax.scan``): each one's gradient is
    accumulated in the parameters' f32 ``.grad`` by ``backward()``, AdamW
    (built with ``microbatches``) divides the sum by their count, and loss
    and nll are the microbatches' means. AdamW updates ``params`` and
    ``opt_state`` IN PLACE (``optim.adamw``) and they are returned.
    ``params`` are the port's master weights (``init(..., master=True)``
    of the family's model); the step marks them as requiring grad, but
    the frozen leaves (``models.module.FROZEN``).
    ``kernels`` replaces the forward's kernels for comparisons
    (``ops.Kernels``; the plain versions are ``layers.flash_attention_xla``,
    ``mamba2_scan.ssd_chunked_plain``, ``rwkv6_scan.wkv6_chunked_plain``
    and ``moe_gmm.gmm_plain``).

    ``rules`` (``sharding.ShardingRules``, default None) adds the
    reference's sharding constraints and KV replication to the forward,
    for parameters that are DTensors placed by ``sharding.tree_shardings``
    (this and every step builder below).

    Called inside a Trainer's ``step`` span (``trace.current_recorder``),
    the step records ``forward`` and ``backward`` a microbatch and one
    ``optimizer`` (AdamW's update, the division included) as its children,
    each with device marks when the parameters are on a card.

    A plain ``ModelConfig`` that names a preset of ``port_configs`` is
    taken as that preset (``port_configs.resolve``)."""
    cfg = port_configs.resolve(cfg)
    opt = AdamW(lr=tc.lr, beta1=tc.beta1, beta2=tc.beta2,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
                microbatches=tc.microbatches)
    n_mb = tc.microbatches

    def train_step(params, opt_state, batch):
        ps = leaves(params)
        rec, cuda = current_recorder(), ps[0].device.type == "cuda"
        _require_grads(params)
        rows = batch["tokens"].shape[0]
        if rows % n_mb:
            raise ValueError(f"{rows} rows do not split into {n_mb} "
                             f"microbatches")
        losses, nlls = [], []
        for i in range(n_mb):
            with _phase(rec, "forward", cuda):
                # rows i * rows/n_mb on, as the reference's reshape to
                # [n_mb, rows/n_mb, ...] takes them; a DTensor's slice of
                # its split batch is split over the batch axes again
                mb = {k: constrain(v.narrow(0, i * (rows // n_mb),
                                            rows // n_mb), rules, "batch")
                      for k, v in batch.items()}
                loss, aux = loss_fn(params, cfg, mb, tc, kernels, rules)
            with _phase(rec, "backward", cuda):
                loss.backward()
            losses.append(loss.detach())
            nlls.append(aux["nll"].detach())
        with _phase(rec, "optimizer", cuda):
            params, opt_state, gnorm = opt.update(_grads(params), opt_state,
                                                  params)
        for p in ps:
            p.grad = None
        metrics = {"loss": torch.stack(losses).mean(), "grad_norm": gnorm,
                   "nll": torch.stack(nlls).mean()}
        return params, opt_state, metrics

    return train_step, opt


def _require_grads(tree, frozen: bool = False) -> None:
    """Mark every leaf of ``tree`` as requiring a gradient, but those under
    a key of ``module.FROZEN``, and clear every ``.grad``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _require_grads(v, frozen or k in FROZEN)
        return
    tree.requires_grad_(not frozen)
    tree.grad = None


def _grads(params):
    """The ``.grad`` of every parameter, in the params' structure."""
    if isinstance(params, dict):
        return {k: _grads(v) for k, v in params.items()}
    return params.grad


def make_prefill_step(cfg: ModelConfig, kernels: ops.Kernels = ops.KERNELS,
                      *, rules=None):
    """``prefill_step(params, batch) -> (logits [B,S,V] float32,
    next_token [B] int32)``: the no-cache forward without gradients."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = _call_forward(params, cfg, batch, kernels, rules)
        return logits, torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    return prefill_step


def make_serve_step(cfg: ModelConfig, kernels: ops.Kernels = ops.KERNELS,
                    *, rules=None):
    """One decode step over the family's carried dense cache (its
    ``init_cache``: ``{k,v: [L,B,S,KV,hd]}`` for the transformer and the
    encoder-decoder's decoder, ``{kv, ssm, conv}`` for the hybrid, ``{wkv,
    shift1, shift2}`` for rwkv6): ``(params, cache, token [B,1], cache_len
    [B], enc_out=None) -> (next_token [B] int32, cache)``. The
    encoder-decoder takes ``enc_out [B,S_enc,D]`` (``encdec.encode``); the
    other families ignore it, as the reference's step does.

    ``kernels.attend(q [B,H,hd], k, v [B,S,KV,hd], lens, k_new, v_new)``
    is the dense attention (and, without ``k_new``, the encoder-decoder's
    cross-attention of the new row over ``enc_out``): ``None`` takes the
    CUDA kernel wrapper ``kernels.ops.decode_attention`` (its plain version
    on CPU tensors); ``kernels.ops.decode_attention_plain`` forces the
    plain version, for comparisons. ``kernels.gmm`` is an MoE layer's
    grouped matmul (default ``ops.gmm``). The cache is updated in place
    and returned."""
    forward = get_api(cfg).forward

    @torch.no_grad()
    def serve_step(params, cache, token, cache_len, enc_out=None):
        kw = dict(cache_len=cache_len, cache=cache, kernels=kernels,
                  rules=rules)
        if cfg.family == Family.ENCDEC:
            kw["enc_out"] = enc_out
        logits, new_cache = forward(params, cfg, token, **kw)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step


def make_paged_serve_step(cfg: ModelConfig,
                          kernels: ops.Kernels = ops.KERNELS, *, rules=None):
    """One paged decode step over the genesys.pagedkv arena:
    ``(params, arenas {k,v: [L,NB,BS,KV,hd]}, block_tables [B,MB],
    token [B,1], cache_len [B]) -> (next_token [B] int32, arenas)``.

    ``kernels.attend(q [B,H,hd], k_pages, v_pages, block_tables, lens)`` is
    the paged attention: ``None`` takes the CUDA kernel wrapper
    ``kernels.ops.paged_decode_attention`` (its plain version on CPU
    tensors); ``kernels.ops.paged_decode_attention_plain`` forces the
    plain version, for comparisons. ``kernels.gmm`` is an MoE layer's
    grouped matmul (default ``ops.gmm``). The arenas are updated in place and
    returned. The batch shape is the engine's fixed slot count: admitting
    or retiring a request changes only row contents, never a shape (an MoE
    layer's capacity then counts the inactive slots' tokens too, as the
    reference's step does).
    """
    if cfg.family not in transformer.DECODER_FAMILIES:
        raise ValueError(
            f"paged decode supports transformer-family archs, not "
            f"{cfg.family} (SSM/hybrid state is not block-addressable)")

    @torch.no_grad()
    def paged_serve_step(params, arenas, block_tables, token, cache_len):
        logits, new_arenas = transformer.forward(
            params, cfg, token, cache_len=cache_len,
            paged_cache=(arenas["k"], arenas["v"], block_tables),
            kernels=kernels, rules=rules)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_arenas

    return paged_serve_step

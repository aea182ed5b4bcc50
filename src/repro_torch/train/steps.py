"""Step builders of the PyTorch port (the counterpart of
``repro.train.steps``): the train step, the prefill step, the paged serve
step and the dense-cache serve step, each over the family's model from
``models.registry``.

Batch dict convention (the reference's):
  tokens  [B, S_text] int32        (always)
  labels  [B, S_text] int32        (train; -100 = masked)
  embeds  [B, P, D]   compute_dtype (vlm patch stub, optional)
"""
from __future__ import annotations

import torch

from repro_torch.config import Family, ModelConfig, TrainConfig
from repro_torch.models import transformer
from repro_torch.models.registry import get_api
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import leaves

IGNORE = -100


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """logits [B,S,V] f32; labels [B,S] with IGNORE masking. Returns
    ``(loss, nll)``: the mean over unmasked positions of nll + z_loss *
    lse^2, and of nll alone."""
    mask = labels != IGNORE
    labels_safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    zl = z_loss * torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1)
    return (nll + zl).sum() / denom, nll.sum() / denom


def loss_fn(params, cfg: ModelConfig, batch, tc: TrainConfig, attend=None,
            ssd=None):
    """The no-cache forward and :func:`cross_entropy` over the text
    positions (a VLM's logits over its patch prefix are dropped). Returns
    ``(loss, {"nll": nll})``."""
    logits, _ = get_api(cfg).forward(params, cfg, batch["tokens"],
                                     embeds=batch.get("embeds"),
                                     attend=attend, ssd=ssd)
    if cfg.family == Family.VLM and batch.get("embeds") is not None:
        logits = logits[:, batch["embeds"].shape[1]:]
    loss, nll = cross_entropy(logits, batch["labels"], tc.z_loss)
    return loss, {"nll": nll}


def make_train_step(cfg: ModelConfig, tc: TrainConfig, attend=None,
                    ssd=None):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` with ``loss``, ``grad_norm`` and
    ``nll`` as 0-d tensors.

    ``tc.microbatches > 1`` splits the batch's rows into that many
    microbatches (the reference's ``lax.scan``): each one's gradient is
    accumulated in the parameters' f32 ``.grad`` by ``backward()``, the
    sum is divided by ``microbatches``, and loss and nll are the
    microbatches' means. Then AdamW updates ``params`` and ``opt_state``
    IN PLACE (``optim.adamw``) and they are returned. ``params`` are the
    port's master weights (``init(..., master=True)`` of the family's
    model); the step marks them as requiring grad. ``attend`` is the
    layers' attention (default: ``ops.flash_attention``;
    ``layers.flash_attention_xla`` is the plain version), ``ssd`` a hybrid's
    scan (default: ``ops.mamba2_ssd``; ``mamba2_scan.ssd_chunked_plain`` is
    the plain version)."""
    get_api(cfg)
    opt = AdamW(lr=tc.lr, beta1=tc.beta1, beta2=tc.beta2,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
    n_mb = tc.microbatches

    def train_step(params, opt_state, batch):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
            p.grad = None
        rows = batch["tokens"].shape[0]
        if rows % n_mb:
            raise ValueError(f"{rows} rows do not split into {n_mb} "
                             f"microbatches")
        losses, nlls = [], []
        for i in range(n_mb):
            mb = {k: v.reshape(n_mb, rows // n_mb, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, aux = loss_fn(params, cfg, mb, tc, attend, ssd)
            loss.backward()
            losses.append(loss.detach())
            nlls.append(aux["nll"].detach())
        grads = _grads(params)
        if n_mb > 1:
            for g in leaves(grads):
                g.div_(n_mb)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        for p in ps:
            p.grad = None
        metrics = {"loss": torch.stack(losses).mean(), "grad_norm": gnorm,
                   "nll": torch.stack(nlls).mean()}
        return params, opt_state, metrics

    return train_step, opt


def _grads(params):
    """The ``.grad`` of every parameter, in the params' structure."""
    if isinstance(params, dict):
        return {k: _grads(v) for k, v in params.items()}
    return params.grad


def make_prefill_step(cfg: ModelConfig, attend=None, ssd=None):
    """``prefill_step(params, batch) -> (logits [B,S,V] float32,
    next_token [B] int32)``: the no-cache forward without gradients."""
    forward = get_api(cfg).forward

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = forward(params, cfg, batch["tokens"],
                            embeds=batch.get("embeds"), attend=attend,
                            ssd=ssd)
        return logits, torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    return prefill_step


def make_serve_step(cfg: ModelConfig, attend=None):
    """One decode step over the family's carried dense cache (its
    ``init_cache``: ``{k,v: [L,B,S,KV,hd]}`` for the transformer, ``{kv,
    ssm, conv}`` for the hybrid): ``(params, cache, token [B,1], cache_len
    [B]) -> (next_token [B] int32, cache)``.

    ``attend(q [B,H,hd], k, v [B,S,KV,hd], lens, k_new, v_new)`` is the
    dense attention: ``None`` takes the CUDA kernel wrapper
    ``kernels.ops.decode_attention`` (its plain version on CPU tensors);
    ``kernels.ops.decode_attention_plain`` forces the plain version, for
    comparisons. The cache is updated in place and returned."""
    forward = get_api(cfg).forward

    @torch.no_grad()
    def serve_step(params, cache, token, cache_len):
        logits, new_cache = forward(params, cfg, token, attend=attend,
                                    cache_len=cache_len, cache=cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step


def make_paged_serve_step(cfg: ModelConfig, attend=None):
    """One paged decode step over the genesys.pagedkv arena:
    ``(params, arenas {k,v: [L,NB,BS,KV,hd]}, block_tables [B,MB],
    token [B,1], cache_len [B]) -> (next_token [B] int32, arenas)``.

    ``attend(q [B,H,hd], k_pages, v_pages, block_tables, lens)`` is the
    paged attention: ``None`` takes the CUDA kernel wrapper
    ``kernels.ops.paged_decode_attention`` (its plain version on CPU
    tensors); ``kernels.ops.paged_decode_attention_plain`` forces the
    plain version, for comparisons. The arenas are updated in place and
    returned. The batch shape is the engine's fixed slot count: admitting
    or retiring a request changes only row contents, never a shape.
    """
    if cfg.family not in transformer.DECODER_FAMILIES:
        raise ValueError(
            f"paged decode in the port supports the dense transformer, not "
            f"{cfg.family} (MoE is a later slice of the port; SSM/hybrid "
            f"state is not block-addressable)")

    @torch.no_grad()
    def paged_serve_step(params, arenas, block_tables, token, cache_len):
        logits, new_arenas = transformer.forward(
            params, cfg, token, cache_len=cache_len,
            paged_cache=(arenas["k"], arenas["v"], block_tables),
            attend=attend)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_arenas

    return paged_serve_step

"""remat="dots" in the port (``models.module.save_products``, a
selective-checkpoint policy) against the JAX package's
``checkpoint_dots_with_no_batch_dims`` on bridged weights: loss and
gradients of reduced starcoder2-7b and qwen2-72b under "dots" against
``jax.grad`` under "dots", and within the port against "none" and
"full"; the products the policy keeps are a layer's weight products,
whichever op an einsum lands on; the recurrent families and the
encoder-decoder checkpoint whole layers under "dots", as the reference's
do. Float32 compute, the tolerances of ``test_torch_train.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as ckpt

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_config
from repro.models.registry import get_api as jax_api
from repro.sharding import rules_for
from repro.train import steps as jsteps
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import module
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import leaves
from repro_torch.train import steps as tsteps
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
REL = 1e-5


def _grads(cfg, params, batch, kernels=ops.KERNELS):
    for p in leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, _ = tsteps.loss_fn(params, cfg, batch, TrainConfig(), kernels)
    loss.backward()
    return loss.item(), [p.grad.clone() for p in leaves(params)]


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(2, 17))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-72b"])
def test_dots_grads_match_jax_and_the_other_modes(arch, mesh11):
    jcfg = dataclasses.replace(jax_config(arch).reduced(),
                               compute_dtype="float32", remat="dots")
    params, _ = jax_api(jcfg).init(jax.random.PRNGKey(5), jcfg)
    np_batch = _batch(jcfg, 3)
    rules = rules_for(jcfg, mesh11)
    with mesh11:
        (jloss, _), jgrads = jax.jit(lambda p, b: jax.value_and_grad(
            jsteps.loss_fn, has_aux=True)(p, jcfg, rules, b,
                                          JTrainConfig()))(
            params, jax.tree_util.tree_map(jax.numpy.asarray, np_batch))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    got = {}
    for remat in ("dots", "none", "full"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  compute_dtype="float32", remat=remat)
        got[remat] = _grads(cfg, from_jax_params(np_params, cfg, "cpu",
                                                 master=True), batch)
    loss, grads = got["dots"]
    np.testing.assert_allclose(loss, float(jloss), atol=LOSS_ATOL)
    flat = jax.tree_util.tree_leaves(jgrads)
    assert len(flat) == len(grads)
    for g, j in zip(grads, flat):
        j = np.asarray(j, np.float32)
        tol = max(REL * float(np.abs(j).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), j, atol=tol)
    for remat in ("none", "full"):
        assert got[remat][0] == loss
        for a, b in zip(got[remat][1], grads):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("arch,per_layer", [("starcoder2-7b", 6),
                                            ("qwen2-72b", 7)])
def test_dots_keeps_the_weight_products(arch, per_layer):
    """q, k, v, o and the MLP's (6 with the GELU MLP, 7 with SwiGLU) a
    layer, nothing of the attention; a policy that keeps nothing keeps
    nothing and still gives the same gradients."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32", remat="dots")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4).items()}
    params = get_api(cfg).init(cfg, seed=0, device="cpu", master=True)
    module.save_products.saved = 0
    ref = _grads(cfg, params, batch)
    assert module.save_products.saved == per_layer * cfg.n_layers

    def keep_nothing(ctx, op, *args, **kwargs):
        return ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    module.save_products.saved = 0
    got = _grads(cfg, params, batch, ops.Kernels(dots_policy=keep_nothing))
    assert module.save_products.saved == 0
    assert got[0] == ref[0]
    for a, b in zip(got[1], ref[1]):
        assert torch.equal(a, b)


def test_einsum_weight_products_count_as_unbatched():
    """An einsum with no batch dim lands on aten.bmm over a batch of one;
    the policy keeps it as it keeps aten.mm, and recomputes a bmm over a
    batch of more than one."""
    class Ctx:
        is_recompute = False
    x, w = torch.randn(1, 5, 4), torch.randn(1, 4, 3)
    keep = ckpt.CheckpointPolicy.MUST_SAVE
    aten = torch.ops.aten
    n = module.save_products.saved
    assert module.save_products(Ctx, aten.bmm.default, x, w) == keep
    assert module.save_products(Ctx, aten.mm.default, x[0], w[0]) == keep
    assert module.save_products(Ctx, aten.bmm.default, x.expand(2, 5, 4),
                                w.expand(2, 4, 3)) != keep
    assert module.save_products.saved == n + 2


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b",
                                  "seamless-m4t-medium"])
def test_other_families_checkpoint_whole_layers_under_dots(arch):
    """As the reference's (``jax.checkpoint`` of the layer for any remat
    but "none"): no product is kept by the policy, and the gradients equal
    "full"'s bit for bit."""
    base = dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")
    np_batch = _batch(base, 6)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    if base.n_frame_tokens:
        batch["embeds"] = torch.randn(2, base.n_frame_tokens, base.d_model,
                                      generator=torch.Generator().manual_seed(0))
    out = {}
    for remat in ("full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        params = get_api(cfg).init(cfg, seed=0, device="cpu", master=True)
        module.save_products.saved = 0
        out[remat] = _grads(cfg, params, batch)
        assert module.save_products.saved == 0
    assert out["dots"][0] == out["full"][0]
    for a, b in zip(out["dots"][1], out["full"][1]):
        assert torch.equal(a, b)

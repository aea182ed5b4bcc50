"""The port's training and prefill steps against the JAX package's on
bridged weights, on reduced starcoder2-7b (tanh-GELU MLP), qwen2-72b (qkv
bias) and internlm2-20b (SwiGLU): ``cross_entropy`` with IGNORE labels,
``loss_fn`` and its gradients against ``jax.value_and_grad``, one
``make_train_step`` (with and without microbatches: loss, grad norm,
updated parameters, moments and count), AdamW alone (f32 and bf16
moments), and ``make_prefill_step``. Within the port: microbatches=4
against 1 (``test_system.py``'s), decode through the carried cache against
prefill (``test_models.py``'s), the remat modes, and the families the
port once refused to train. Comparisons run in float32 compute unless a test
says otherwise; the weights are the JAX package's, bridged as float32
master weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_config
from repro.models.registry import get_api
from repro.optim import AdamW as JAdamW
from repro.sharding import rules_for
from repro.train import steps as jsteps
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import adamw as kadamw
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import leaves
from repro_torch.train import steps as tsteps
from repro_torch.weights import from_jax_params, to_numpy_tree

torch.set_num_threads(1)

ARCHS = ["starcoder2-7b", "qwen2-72b", "internlm2-20b"]
F32 = dict(compute_dtype="float32")
# f32 sums in another order than XLA's (matmuls over <= 256, softmax and
# logsumexp over <= 512): losses to 1e-5, gradients and moments to 1e-5
# of their largest |value| (at least 1e-6). AdamW moves each parameter by
# lr times a step in [-1, 1] (the first step is g / (|g| + eps)); where
# |g| is near eps = 1e-8 a gradient difference of 1e-5 of the leaf's
# largest value moves that step by up to ~1e-2, so parameters are held to
# a tenth of lr (3e-5 at the default lr 3e-4, 1e-3 at AdamW's test lr)
LOSS_ATOL = 1e-5
REL = 1e-5
PARAM_ATOL = 0.1 * TrainConfig().lr


def _setup(arch, mesh11, **dtypes):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **dtypes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **dtypes)
    params, _ = get_api(jcfg).init(jax.random.PRNGKey(4), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, np_params, rules_for(jcfg, mesh11)


def _tparams(np_params, cfg):
    return from_jax_params(np_params, cfg, device="cpu", master=True)


def _batch(cfg, rng, rows=4, seq=16, ignore=True):
    toks = rng.integers(0, cfg.vocab_size, size=(rows, seq + 1))
    labels = toks[:, 1:].copy()
    if ignore:
        labels[:, :3] = tsteps.IGNORE
    np_batch = {"tokens": toks[:, :-1].astype(np.int32),
                "labels": labels.astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _assert_tree_close(got, want, rel=REL, atol=None, what=""):
    """Every leaf of ``got`` (numpy tree) within ``atol`` of ``want``, or
    within ``rel`` of the leaf's largest |value| (at least 1e-6)."""
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b, np.float32)
        tol = atol if atol is not None else rel * max(np.abs(b).max(), 0.1)
        np.testing.assert_allclose(np.asarray(a, np.float32), b, atol=tol,
                                   rtol=0, err_msg=what)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 33), dtype=np.float32) * 3
    labels = rng.integers(0, 33, size=(2, 7)).astype(np.int32)
    labels[0, :4] = tsteps.IGNORE
    jl, jn = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tl, tn = tsteps.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), float(jl), atol=LOSS_ATOL)
    np.testing.assert_allclose(tn.item(), float(jn), atol=LOSS_ATOL)
    # every label masked: the denominator is clamped to 1, both give 0
    none = np.full_like(labels, tsteps.IGNORE)
    assert tsteps.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(none))[0].item() == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, mesh11):
    jcfg, cfg, params, np_params, rules = _setup(arch, mesh11, **F32)
    jb, tb = _batch(cfg, np.random.default_rng(1))
    with mesh11:
        (jloss, jaux), jgrads = jax.jit(lambda p, b: jax.value_and_grad(
            jsteps.loss_fn, has_aux=True)(p, jcfg, rules, b,
                                          JTrainConfig()))(params, jb)
    tparams = _tparams(np_params, cfg)
    for p in leaves(tparams):
        p.requires_grad_(True)
    tloss, taux = tsteps.loss_fn(tparams, cfg, tb, TrainConfig())
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=LOSS_ATOL)
    np.testing.assert_allclose(taux["nll"].item(), float(jaux["nll"]),
                               atol=LOSS_ATOL)
    tgrads = jax.tree_util.tree_map(lambda p: p.grad, tparams)
    _assert_tree_close(to_numpy_tree(tgrads), jgrads, what="grads")


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, microbatches, mesh11):
    jcfg, cfg, params, np_params, rules = _setup(arch, mesh11, **F32)
    jb, tb = _batch(cfg, np.random.default_rng(2))
    jts, jopt = jsteps.make_train_step(jcfg, rules, JTrainConfig(
        microbatches=microbatches))
    with mesh11:
        jp, jstate, jm = jax.jit(jts)(params, jopt.init(params), jb)
    ts, opt = tsteps.make_train_step(cfg, TrainConfig(
        microbatches=microbatches))
    tparams = _tparams(np_params, cfg)
    tstate = opt.init(tparams)
    tp, tstate2, tm = ts(tparams, tstate, tb)
    assert tp is tparams and tstate2 is tstate      # updated in place
    for name in ("loss", "grad_norm", "nll"):
        assert tm[name].dim() == 0
        np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                   atol=LOSS_ATOL, rtol=1e-5, err_msg=name)
    _assert_tree_close(to_numpy_tree(tp), jp, atol=PARAM_ATOL, what="params")
    _assert_tree_close(to_numpy_tree(tstate.m), jstate.m, what="m")
    _assert_tree_close(to_numpy_tree(tstate.v), jstate.v, what="v")
    assert tstate.count.dtype == torch.int32
    assert tstate.count.item() == int(jstate.count) == 1
    assert all(p.grad is None for p in leaves(tp))   # gradients freed


def test_microbatched_train_step_matches_single():
    """test_system.py's: gradient accumulation over 4 microbatches is
    loss-equivalent to the full batch (default dtypes: bf16 compute)."""
    cfg = get_config("starcoder2-7b").reduced()
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 100, (4, 16))),
             "labels": torch.from_numpy(rng.integers(0, 100, (4, 16)))}
    out = {}
    for mb in (1, 4):
        params = ttr.init(cfg, seed=0, device="cpu", master=True)
        ts, opt = tsteps.make_train_step(cfg, TrainConfig(microbatches=mb))
        out[mb] = ts(params, opt.init(params), batch)
    (p1, _, m1), (p4, _, m4) = out[1], out[4]
    assert abs(m1["loss"].item() - m4["loss"].item()) < 2e-3
    err = max((a - b).abs().max().item()
              for a, b in zip(leaves(p1), leaves(p4)))
    assert err < 5e-3, err


@pytest.mark.parametrize("moments_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(moments_dtype):
    """Three AdamW updates of the same parameters in both packages, each
    with fresh gradients whose global norm exceeds the clip. bf16 moments:
    rounded to bf16 in both, held to one bf16 ulp of the largest."""
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 4)}}
    np_p = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s, dtype=np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    np_gs = [jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s, dtype=np.float32) * 0.3, shapes,
        is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    kw = dict(lr=1e-2, moments_dtype=moments_dtype)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    tp = jax.tree_util.tree_map(torch.tensor, np_p)
    js, ts = jopt.init(jp), topt.init(tp)
    for np_g in np_gs:
        jp, js, jn = jopt.update(jax.tree_util.tree_map(jnp.asarray, np_g),
                                 js, jp)
        tp, ts, tn = topt.update(jax.tree_util.tree_map(torch.tensor, np_g),
                                 ts, tp)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    _assert_tree_close(to_numpy_tree(tp), jp, atol=0.1 * kw["lr"])
    rel = REL if moments_dtype == "float32" else 2 ** -8   # one bf16 ulp
    for got, want in ((ts.m, js.m), (ts.v, js.v)):
        assert all(x.dtype == getattr(torch, moments_dtype)
                   for x in leaves(got))
        _assert_tree_close(to_numpy_tree(got),
                           jax.tree_util.tree_map(
                               lambda x: np.asarray(x.astype(jnp.float32)),
                               want), rel=rel)
    assert ts.count.item() == int(js.count) == 3


@pytest.mark.parametrize("clip", ["engaged", "not_engaged"])
def test_kernel_arithmetic_matches_jax(clip):
    """The AdamW kernels' arithmetic (``kernels.adamw``'s plain version)
    over three updates against the JAX
    package's, with fresh gradients whose global norm exceeds the clip or
    stays under it; held as the eager route is above."""
    rng = np.random.default_rng(8)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 4)}, "e": (1,)}
    scale = 0.3 if clip == "engaged" else 0.01
    np_p = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s, dtype=np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    np_gs = [jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s, dtype=np.float32) * scale, shapes,
        is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    hp = dict(lr=1e-2, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip=1.0)
    jopt = JAdamW(**hp)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    tp = leaves(jax.tree_util.tree_map(torch.tensor, np_p))
    js = jopt.init(jp)
    tm, tv = [torch.zeros_like(p) for p in tp], [torch.zeros_like(p)
                                                  for p in tp]
    count = torch.zeros((), dtype=torch.int32)
    for np_g in np_gs:
        jp, js, jn = jopt.update(jax.tree_util.tree_map(jnp.asarray, np_g),
                                 js, jp)
        tg = leaves(jax.tree_util.tree_map(torch.tensor, np_g))
        tn = kadamw.adamw_sqnorm_plain(tg)
        kadamw.adamw_update_plain(tp, tg, tm, tv, count, tn, **hp)
        assert (float(jn) > 1) == (clip == "engaged")
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for got, want in ((tp, jp), (tm, js.m), (tv, js.v)):
        _assert_tree_close([t.numpy() for t in got],
                           jax.tree_util.tree_leaves(want),
                           atol=0.1 * hp["lr"] if got is tp else None)
    assert count.item() == int(js.count) == 3


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-72b"])
def test_prefill_step_matches_jax(arch, mesh11):
    jcfg, cfg, params, np_params, rules = _setup(arch, mesh11, **F32)
    jb, tb = _batch(cfg, np.random.default_rng(5), ignore=False)
    with mesh11:
        jl, jn = jax.jit(jsteps.make_prefill_step(jcfg, rules))(params, jb)
    tl, tn = tsteps.make_prefill_step(cfg)(_tparams(np_params, cfg), tb)
    assert tl.dtype == torch.float32 and tn.dtype == torch.int32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    assert tn.tolist() == np.asarray(jn).tolist()


def test_dense_decode_matches_prefill():
    """test_models.py's: greedy decode through the carried KV cache
    matches the argmax of the full no-cache forward (default dtypes, bf16
    compute; the serving weights)."""
    cfg = get_config("internlm2-20b").reduced()
    params = ttr.init(cfg, seed=1, device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 100, (B, S)))
    with torch.no_grad():
        full, _ = ttr.forward(params, cfg, toks)
        cache = ttr.init_cache(cfg, B, 32, device="cpu")
        outs = []
        for t in range(S):
            logits, cache = ttr.forward(
                params, cfg, toks[:, t:t + 1], cache=cache,
                cache_len=torch.full((B,), t, dtype=torch.int32))
            outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(torch.softmax(full, -1).numpy(),
                               torch.softmax(dec, -1).numpy(), atol=3e-2)
    assert torch.equal(full.argmax(-1), dec.argmax(-1))


def test_remat_modes_give_equal_grads():
    """remat "full" (activation checkpointing) and "dots" (the weight
    products kept, the rest recomputed) run the same block, so their
    gradients equal "none"'s."""
    base = dataclasses.replace(get_config("starcoder2-7b").reduced(), **F32)
    _, tb = _batch(base, np.random.default_rng(7))
    grads = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        params = ttr.init(cfg, seed=0, device="cpu", master=True)
        for p in leaves(params):
            p.requires_grad_(True)
        tsteps.loss_fn(params, cfg, tb, TrainConfig())[0].backward()
        grads[remat] = [p.grad for p in leaves(params)]
    for remat in ("full", "dots"):
        for a, b in zip(grads[remat], grads["none"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_master_weights_are_float32_and_serving_weights_compute_dtype():
    cfg = get_config("starcoder2-7b").reduced()
    master = ttr.init(cfg, seed=0, device="cpu", master=True)
    serve = ttr.init(cfg, seed=0, device="cpu")
    assert all(p.dtype == torch.float32 for p in leaves(master))
    assert serve["blocks"]["mlp"]["wi_up"].dtype == torch.bfloat16
    assert serve["blocks"]["ln_attn"].dtype == torch.float32
    torch.testing.assert_close(serve["embed"],
                               master["embed"].to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "moonshot-v1-16b-a3b"])
def test_steps_reject_families_the_port_does_not_train(arch):
    """The port once refused these families; it now trains every family
    of the reference, so both steps build for each (their parity with the
    JAX package is in ``test_torch_encdec.py`` and
    ``test_torch_moe_serve.py``)."""
    cfg = get_config(arch).reduced()
    assert callable(tsteps.make_train_step(cfg, TrainConfig())[0])
    assert callable(tsteps.make_prefill_step(cfg))

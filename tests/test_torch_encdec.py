"""The encoder-decoder family (reduced seamless-m4t-medium) of the port
against the JAX package on the CPU, on weights bridged from
``repro.models.encdec.init`` and inputs made with numpy from a seed.

The bridge in both modes against the port's own ``init`` tree; the
attention layer's cross-attention (``kv_x``, no cache and at decode) and
non-causal branch against the JAX ``attention``; ``encode``; the no-cache
logits in f32 and bf16; 12 decode steps of the serve step over a carried
cache with ragged ``cache_len`` and ``enc_out`` (tokens equal, logits and
caches close); decode against prefill inside the port; the prefill step;
loss and gradients (remat "none" and "full") and a train step with one
and two microbatches against ``make_train_step`` with ``embeds`` as the
frames; an encoder-decoder training state crossing between the two
packages' ``CheckpointManager`` both ways; and the errors of a forward
without frames or without ``enc_out``. f32 compute unless a test says
otherwise; tolerances as in ``test_torch_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_config
from repro.models import encdec as jencdec
from repro.models import layers as jl
from repro.optim import AdamW as JAdamW
from repro.sharding import rules_for
from repro.train import steps as jsteps
from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
from repro_torch.config import Family, TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tl
from repro_torch.models.registry import get_api
from repro_torch.optim import OptState
from repro_torch.optim.adamw import leaves
from repro_torch.train import steps as tsteps
from repro_torch.weights import from_jax_params, to_numpy_tree
from test_torch_train import (
    LOSS_ATOL, PARAM_ATOL, REL, _assert_tree_close, _batch,
)

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
F32 = dict(params_dtype="float32", compute_dtype="float32",
           kv_cache_dtype="float32")
# bf16 compute: both packages round every op's output to bf16, in other
# orders; logits through 2 + 2 layers differ by a few bf16 ulps of the
# largest (2**-8 relative each): held to 2**-5 of the largest |logit|
BF16_REL = 2.0 ** -5
S_ENC = 24          # frames a row (the reduced config's n_frame_tokens: 16)


def _configs(**over):
    return (dataclasses.replace(jax_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


def _jax_params(jcfg, seed=4):
    params, _ = jencdec.init(jax.random.PRNGKey(seed), jcfg)
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs(**F32)
    return (jcfg, cfg) + _jax_params(jcfg)


def _frames(cfg, seed, rows=4, s=S_ENC):
    return np.random.default_rng(seed).standard_normal(
        (rows, s, cfg.d_model), dtype=np.float32)


def _close(got, want, rel=REL, what=""):
    """Every element within ``rel`` of the largest |want| (at least 1e-3)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-3),
                               err_msg=what)


def _leaf_specs(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _leaf_specs(v, f"{prefix}/{k}").items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


def test_registry_and_steps_take_the_encoder_decoder():
    cfg = get_config(ARCH).reduced()
    api = get_api(cfg)
    assert cfg.family == Family.ENCDEC
    assert api.init is ted.init and api.forward is ted.forward
    cache = api.init_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
    assert callable(tsteps.make_train_step(cfg, TrainConfig())[0])
    assert callable(tsteps.make_prefill_step(cfg))
    assert callable(tsteps.make_serve_step(cfg))
    with pytest.raises(ValueError, match="transformer-family"):
        tsteps.make_paged_serve_step(cfg)


@pytest.mark.parametrize("master", [False, True], ids=["serve", "master"])
def test_init_tree_matches_the_bridged_tree(master):
    """The port's ``init`` and the bridge of the JAX package's ``init``
    give the same paths, shapes and held dtypes (serving: matrices in the
    compute dtype, the norm scales in float32; master: all float32), and
    the reduced tree holds ``param_count()`` parameters."""
    jcfg, cfg = _configs()
    _, np_params = _jax_params(jcfg)
    bridged = from_jax_params(np_params, cfg, device="cpu", master=master)
    own = ted.init(cfg, seed=0, device="cpu", master=master)
    assert _leaf_specs(own) == _leaf_specs(bridged)
    assert sum(t.numel() for t in flatten(own)) == cfg.param_count()
    want = torch.float32 if master else torch.bfloat16
    assert own["decoder"]["cross_attn"]["wk"].dtype == want
    assert own["decoder"]["ln_cross"].dtype == torch.float32
    # the layers draw from their own name-keyed generators
    assert not torch.equal(own["encoder"]["attn"]["wq"][0],
                           own["encoder"]["attn"]["wq"][1])
    assert not torch.equal(own["decoder"]["self_attn"]["wq"][0],
                           own["decoder"]["cross_attn"]["wq"][0])


@pytest.mark.parametrize("mode", ["cross", "cross-decode", "non-causal"])
def test_attention_kv_x_and_causal_match_jax(mode, mesh11):
    """Cross-attention (``kv_x``: K/V from the source, no rope, not
    causal) of 5 query rows, and of one row a request as a decode step
    routes it (the dense decode attention over the source, no new token),
    and the encoder's non-causal self-attention with rope, against the
    JAX ``attention``."""
    jcfg, cfg = _configs(**F32)
    rng = np.random.default_rng(3)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": rng.standard_normal((D, H, hd), dtype=np.float32) * D ** -0.5,
         "wk": rng.standard_normal((D, KV, hd), dtype=np.float32) * D ** -.5,
         "wv": rng.standard_normal((D, KV, hd), dtype=np.float32) * D ** -.5,
         "wo": rng.standard_normal((H, hd, D), dtype=np.float32)
         * (H * hd) ** -0.5}
    B, S = 3, (1 if mode == "cross-decode" else 5)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    src = rng.standard_normal((B, 11, D), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) + 2, (B, S)).copy()
    kw_j = dict(kv_x=jnp.asarray(src)) if mode != "non-causal" else {}
    want, _ = jl.attention({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                           rules_for(jcfg, mesh11), jnp.asarray(x),
                           positions=jnp.asarray(pos), causal=False, **kw_j)
    tp = from_jax_params(p, cfg, device="cpu")
    if mode == "non-causal":
        step = tl.nocache_step(cfg, torch.from_numpy(pos))
        kw_t = {}
    else:
        kw_t = dict(kv_x=torch.from_numpy(src))
        step = tl.cross_step(kw_t["kv_x"], decode=mode == "cross-decode")
    seen = []

    def attend(*args, **kw):
        seen.append(len(args))
        return (ops.decode_attention if mode == "cross-decode"
                else ops.flash_attention)(*args, **kw)
    got = tl.attention(tp, cfg, torch.from_numpy(x), step=step, causal=False,
                       attend=attend, **kw_t)
    _close(got, want, what=mode)
    # decode: (q, k, v, lens), no new token; else (q, k, v) and causal=
    assert seen == [4 if mode == "cross-decode" else 3]
    if mode == "cross-decode":
        assert step.lens.tolist() == [11] * B
    if mode == "non-causal":    # the flag reaches attend: causal differs
        causal = tl.attention(tp, cfg, torch.from_numpy(x), step=step)
        assert not np.allclose(causal.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_encode_matches_jax(remat, mesh11):
    jcfg, cfg = _configs(remat=remat, **F32)
    params, np_params = _jax_params(jcfg)
    frames = _frames(cfg, 5)
    with mesh11:
        want = jax.jit(lambda p, f: jencdec.encode(
            p, jcfg, rules_for(jcfg, mesh11), f))(params, jnp.asarray(frames))
    with torch.no_grad():
        got = ted.encode(from_jax_params(np_params, cfg, device="cpu"), cfg,
                         torch.from_numpy(frames))
    assert got.shape == (4, S_ENC, cfg.d_model) and got.dtype == torch.float32
    _close(got, want, what="enc_out")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_logits_match_jax(compute, mesh11):
    """The no-cache forward over frames and 12 text tokens: logits
    [B, 12, V] float32."""
    jcfg, cfg = _configs(compute_dtype=compute)
    params, np_params = _jax_params(jcfg)
    frames = _frames(cfg, 6)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(4, 12)).astype(np.int32)
    with mesh11:
        want, _ = jax.jit(lambda p, t, f: jencdec.forward(
            p, jcfg, rules_for(jcfg, mesh11), t, frames=f))(
            params, jnp.asarray(toks), jnp.asarray(frames))
    with torch.no_grad():
        got, cache = ted.forward(from_jax_params(np_params, cfg, device="cpu"),
                                 cfg, torch.from_numpy(toks),
                                 frames=torch.from_numpy(frames))
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (4, 12, cfg.padded_vocab)
    _close(got, want, REL if compute == "float32" else BF16_REL, "logits")


def test_twelve_decode_steps_match_jax_serve_step(model, mesh11):
    """12 greedy steps of three rows through both packages' serve steps
    with their own ``encode``'s enc_out, over a carried cache of 16
    positions with ragged ``cache_len``: row 2 reaches capacity at step 10
    and its writes then drop. Tokens equal, logits and caches close."""
    jcfg, cfg, params, np_params = model
    tparams = from_jax_params(np_params, cfg, device="cpu")
    rules = rules_for(jcfg, mesh11)
    frames = _frames(cfg, 8, rows=3)
    B, MAX = 3, 16
    with mesh11:
        j_enc = jax.jit(lambda p, f: jencdec.encode(p, jcfg, rules, f))(
            params, jnp.asarray(frames))
    with torch.no_grad():
        t_enc = ted.encode(tparams, cfg, torch.from_numpy(frames))
    _close(t_enc, j_enc, what="enc_out")
    jstep = jax.jit(jsteps.make_serve_step(jcfg, rules))
    jlogits = jax.jit(lambda p, c, t, cl, e: jencdec.forward(
        p, jcfg, rules, t, cache=c, cache_len=cl, enc_out=e)[0])
    tstep = tsteps.make_serve_step(cfg)
    jcache = jencdec.init_cache(jcfg, B, MAX)
    tcache = ted.init_cache(cfg, B, MAX, device="cpu")
    cl = np.asarray([0, 3, 6], np.int32)
    tok = np.random.default_rng(9).integers(
        1, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    for i in range(12):
        with mesh11:
            lj = jlogits(params, jcache, jnp.asarray(tok), jnp.asarray(cl),
                         j_enc)
            jn, jcache = jstep(params, jcache, jnp.asarray(tok),
                               jnp.asarray(cl), enc_out=j_enc)
        with torch.no_grad():
            lt, _ = ted.forward(tparams, cfg, torch.from_numpy(tok),
                                cache={n: c.clone() for n, c in
                                       tcache.items()},
                                cache_len=torch.from_numpy(cl), enc_out=t_enc)
        tn, tcache = tstep(tparams, tcache, torch.from_numpy(tok),
                           torch.from_numpy(cl), t_enc)
        _close(lt, lj, what=f"logits step {i}")
        assert tn.tolist() == np.asarray(jn).tolist(), f"step {i}"
        tok = tn.numpy()[:, None].astype(np.int32)
        cl = np.minimum(cl + 1, MAX)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   atol=1e-5)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_decode_matches_prefill(remat):
    """Inside the port: 10 tokens fed one at a time through the carried
    cache with ``enc_out`` give the no-cache forward's logits over the same
    tokens and frames (f32: sums in another order), and its greedy
    tokens."""
    _, cfg = _configs(remat=remat, **F32)
    params = ted.init(cfg, seed=1, device="cpu")
    B, S = 2, 10
    frames = torch.from_numpy(_frames(cfg, 10, rows=B))
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        full, _ = ted.forward(params, cfg, toks, frames=frames)
        enc_out = ted.encode(params, cfg, frames)
        cache = ted.init_cache(cfg, B, 16, device="cpu")
        outs = []
        for t in range(S):
            logits, cache = ted.forward(
                params, cfg, toks[:, t:t + 1], cache=cache,
                cache_len=torch.full((B,), t, dtype=torch.int32),
                enc_out=enc_out)
            outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    _close(dec, full.numpy(), what="decode vs prefill")
    assert torch.equal(full.argmax(-1), dec.argmax(-1))


def _ed_batch(cfg, seed, rows=4, seq=12):
    jb, tb = _batch(cfg, np.random.default_rng(seed), rows=rows, seq=seq)
    frames = _frames(cfg, seed + 100, rows=rows)
    jb["embeds"], tb["embeds"] = jnp.asarray(frames), torch.from_numpy(frames)
    return jb, tb


def test_prefill_step_matches_jax(model, mesh11):
    jcfg, cfg, params, np_params = model
    jb, tb = _ed_batch(cfg, 12)
    with mesh11:
        jl_, jn = jax.jit(jsteps.make_prefill_step(
            jcfg, rules_for(jcfg, mesh11)))(params, jb)
    tl_, tn = tsteps.make_prefill_step(cfg)(
        from_jax_params(np_params, cfg, device="cpu"), tb)
    assert tl_.dtype == torch.float32 and tn.dtype == torch.int32
    _close(tl_, jl_, what="logits")
    assert tn.tolist() == np.asarray(jn).tolist()


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(remat, mesh11):
    """With remat "full" the port checkpoints each encoder and decoder
    layer (the reference's ``jax.checkpoint(body)``); the gradients reach
    the encoder through the cross-attention's K/V."""
    jcfg, cfg = _configs(remat=remat, **F32)
    params, np_params = _jax_params(jcfg)
    rules = rules_for(jcfg, mesh11)
    jb, tb = _ed_batch(cfg, 13)
    with mesh11:
        (jloss, jaux), jgrads = jax.jit(lambda p, b: jax.value_and_grad(
            jsteps.loss_fn, has_aux=True)(p, jcfg, rules, b,
                                          JTrainConfig()))(params, jb)
    tparams = from_jax_params(np_params, cfg, device="cpu", master=True)
    for p in leaves(tparams):
        p.requires_grad_(True)
    tloss, taux = tsteps.loss_fn(tparams, cfg, tb, TrainConfig())
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=LOSS_ATOL)
    np.testing.assert_allclose(taux["nll"].item(), float(jaux["nll"]),
                               atol=LOSS_ATOL)
    tgrads = jax.tree_util.tree_map(lambda p: p.grad, tparams)
    assert tgrads["encoder"]["attn"]["wq"].abs().max() > 0
    _assert_tree_close(to_numpy_tree(tgrads), jgrads, what="grads")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(model, mesh11, microbatches):
    """Loss, grad norm, nll, updated parameters and moments after one step
    of ``make_train_step`` with ``embeds`` as the frames."""
    jcfg, cfg, params, np_params = model
    rules = rules_for(jcfg, mesh11)
    jb, tb = _ed_batch(cfg, 14)
    jts, jopt = jsteps.make_train_step(jcfg, rules, JTrainConfig(
        microbatches=microbatches))
    with mesh11:
        jp, jstate, jm = jax.jit(jts)(params, jopt.init(params), jb)
    ts, opt = tsteps.make_train_step(cfg, TrainConfig(
        microbatches=microbatches))
    tparams = from_jax_params(np_params, cfg, device="cpu", master=True)
    tstate = opt.init(tparams)
    tp, tstate, tm = ts(tparams, tstate, tb)
    for name in ("loss", "grad_norm", "nll"):
        np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                   atol=LOSS_ATOL, rtol=1e-5, err_msg=name)
    _assert_tree_close(to_numpy_tree(tp), jp, atol=PARAM_ATOL, what="params")
    _assert_tree_close(to_numpy_tree(tstate.m), jstate.m, what="m")
    _assert_tree_close(to_numpy_tree(tstate.v), jstate.v, what="v")


@pytest.fixture()
def tgsys():
    from repro_torch.core.genesys import Genesys, GenesysConfig
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    yield g
    g.shutdown()


def _train_state(seed):
    """Reduced seamless's parameters and an AdamW state in both packages,
    the same values."""
    jcfg, cfg = _configs()
    jparams, _ = jencdec.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    jstate = dataclasses.replace(
        JAdamW().init(jparams),
        m=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape, dtype=np.float32)), jparams),
        v=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.random(p.shape, dtype=np.float32)), jparams),
        count=jnp.asarray(3, jnp.int32))

    def bridge(tree):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg,
                               device="cpu", master=True)
    tstate = OptState(m=bridge(jstate.m), v=bridge(jstate.v),
                      count=torch.tensor(3, dtype=torch.int32))
    return ({"params": jparams, "opt": jstate},
            {"params": bridge(jparams), "opt": tstate})


def _zeros(tree):
    if isinstance(tree, OptState):
        return OptState(_zeros(tree.m), _zeros(tree.v),
                        torch.zeros_like(tree.count))
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_jax_checkpoint_of_the_encdec_tree_restores_into_the_port(
        gsys, tgsys, tmp_path):
    jtree, ttree = _train_state(0)
    JCheckpointManager(gsys, str(tmp_path)).save(2, jtree)
    got = CheckpointManager(tgsys, str(tmp_path)).restore(2, _zeros(ttree))
    g, w = flatten(got), flatten(ttree)
    assert len(g) == len(w) == len(jax.tree_util.tree_leaves(jtree))
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_of_the_encdec_tree_restores_into_jax(
        gsys, tgsys, tmp_path):
    jtree, ttree = _train_state(1)
    CheckpointManager(tgsys, str(tmp_path)).save(3, ttree)
    like = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    got = JCheckpointManager(gsys, str(tmp_path)).restore(3, like)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(got["params"]["decoder"]["cross_attn"]["wk"]),
        to_numpy_tree(ttree["params"])["decoder"]["cross_attn"]["wk"])


def test_forward_refuses_a_call_without_its_source():
    """No frames and no enc_out (the reference fails on ``None.astype``),
    and a decode step's cache without enc_out."""
    _, cfg = _configs(**F32)
    params = ted.init(cfg, seed=0, device="cpu")
    toks = torch.ones((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs frames"):
        ted.forward(params, cfg, toks)
    cache = ted.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="give enc_out"):
        ted.forward(params, cfg, toks[:, :1], cache=cache,
                    cache_len=torch.zeros(2, dtype=torch.int32),
                    frames=torch.zeros(2, 4, cfg.d_model))
    with pytest.raises(ValueError, match="give enc_out"):
        tsteps.make_serve_step(cfg)(params, cache, toks[:, :1],
                                    torch.zeros(2, dtype=torch.int32))

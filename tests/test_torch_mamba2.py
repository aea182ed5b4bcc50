"""The port's Mamba2 SSD scan and zamba2 hybrid against the JAX package's,
on the CPU, on the same numpy-seeded inputs and bridged weights.

The scan: ``ssd_chunked_plain`` against ``ssd_chunked`` and against the
Pallas ``mamba2_ssd`` in interpret mode, ``ssd_backward_plain`` against
``jax.vjp``, the ``ops.mamba2_ssd`` autograd.Function on CPU tensors, the
decode recurrence and chunked-equals-recurrence. The model (reduced
zamba2-2.7b: 4 mamba layers, the shared block after every 2):
``mamba_block`` in both branches, the forward's logits in f32 and bf16,
12 decode steps against the JAX package's carried forward, the prefill
step, ``loss_fn``'s gradients and ``make_train_step`` with 1 and 2
microbatches, and the parameter count. Comparisons run in float32 unless
a test says otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.models import mamba2 as jm
from repro.sharding import rules_for
from repro.train import steps as jsteps
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import mamba2_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.models import mamba2 as tm
from repro_torch.models.module import layer_slice
from repro_torch.optim.adamw import leaves
from repro_torch.train import steps as tsteps
from repro_torch.weights import from_jax_params, to_numpy_tree

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
# f32 scans sum in another order than XLA's (chunk products over <= 64
# terms, the running sum of dt A, the carry over <= 8 chunks): outputs and
# gradients to REL of the tensor's largest |value|; readings are below
# 2e-6 of it
REL = 2e-5
LOSS_ATOL = 1e-5
PARAM_ATOL = 0.1 * TrainConfig().lr    # as test_torch_train.py holds them
M_MIN = 1e-7                           # see _assert_params_close
# bf16 compute: both packages round every op's output to bf16, in other
# orders; logits through 4 layers differ by a few bf16 ulps of the
# largest (2**-8 relative each): held to 2**-5 of the largest |logit|
BF16_REL = 2.0 ** -5


def _ssd_inputs(seed, b=2, l=128, h=3, p=8, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((b, l, n), dtype=np.float32)
    Cm = rng.standard_normal((b, l, n), dtype=np.float32)
    dy = rng.standard_normal((b, l, h, p), dtype=np.float32)
    return (x, dt, A, Bm, Cm), dy


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-3),
                               err_msg=what)


# ------------------------------------------------------------- the scan ----

@pytest.mark.parametrize("l,chunk", [(48, 64), (128, 32), (128, 64),
                                     (256, 32), (256, 64)])
def test_ssd_chunked_plain_matches_jax(l, chunk):
    """Including one chunk covering the sequence (c = L = 48 < 64)."""
    ins, _ = _ssd_inputs(0, l=l)
    yj, sj = jm.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    yt, st = tms.ssd_chunked_plain(*map(torch.from_numpy, ins), chunk=chunk)
    assert yt.dtype == torch.float32 and st.shape == sj.shape
    _close(yt, yj, what="y")
    _close(st, sj, what="final state")


def test_ssd_chunk_must_divide_the_sequence():
    """L = 48 with chunk 32: the reference asserts, the port raises."""
    ins, _ = _ssd_inputs(1, l=48)
    with pytest.raises(AssertionError):
        jm.ssd_chunked(*map(jnp.asarray, ins), chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tms.ssd_chunked_plain(*map(torch.from_numpy, ins), chunk=32)


@pytest.mark.parametrize("l,chunk,n,p", [(256, 64, 32, 64),
                                         (128, 32, 16, 32)])
def test_ssd_chunked_plain_matches_pallas_interpret(l, chunk, n, p):
    """The Pallas kernel run as ``tests/test_kernels.py`` runs it (in
    interpret mode, at its shapes)."""
    ins, _ = _ssd_inputs(2, l=l, n=n, p=p)
    yj, sj = jops.mamba2_ssd(*map(jnp.asarray, ins), chunk=chunk)
    yt, st = tms.ssd_chunked_plain(*map(torch.from_numpy, ins), chunk=chunk)
    _close(yt, yj, what="y")
    _close(st, sj, what="final state")


@pytest.mark.parametrize("l,chunk", [(48, 64), (128, 32), (256, 64)])
def test_ssd_backward_plain_matches_jax_vjp(l, chunk):
    ins, dy = _ssd_inputs(3, l=l)
    _, vjp = jax.vjp(lambda *a: jm.ssd_chunked(*a, chunk=chunk)[0],
                     *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(dy))
    got = tms.ssd_backward_plain(*map(torch.from_numpy, ins),
                                 torch.from_numpy(dy), chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want):
        assert g.shape == w.shape
        _close(g, w, what=name)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_ops_mamba2_ssd_on_cpu_is_the_plain_version(x_dtype):
    """On CPU tensors the autograd.Function runs the plain forward and
    backward: y and every gradient equal them exactly, and the final state
    carries no gradient."""
    (x, *rest), dy = _ssd_inputs(4)
    x_t = torch.from_numpy(x).to(x_dtype)
    ins = [x_t] + [torch.from_numpy(a) for a in rest]
    dy_t = torch.from_numpy(dy).to(x_dtype)
    leaves_ = [t.clone().requires_grad_(True) for t in ins]
    y, s = tops.mamba2_ssd(*leaves_)
    y.backward(dy_t)
    y_p, s_p = tms.ssd_chunked_plain(*ins)
    assert y.dtype == x_dtype and not s.requires_grad
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(s, s_p, rtol=0, atol=0)
    for t, g in zip(leaves_, tms.ssd_backward_plain(*ins, dy_t)):
        torch.testing.assert_close(t.grad, g, rtol=0, atol=0)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks a CUDA tensor meets before a launch (run on CPU tensors:
    they do not depend on the device)."""
    ins = tuple(map(torch.from_numpy, _ssd_inputs(5)[0]))
    x, dt, A, Bm, Cm = ins
    assert tms._check(*ins)[-1] == 64
    with pytest.raises(ValueError, match="P and N up to"):
        tms._check(torch.zeros(1, 64, 2, 65), *(torch.zeros(s) for s in (
            (1, 64, 2), (2,), (1, 64, 4), (1, 64, 4))))
    with pytest.raises(TypeError):
        tms._check(x, dt.double(), A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        tms._check(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                   Bm, Cm)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tms._check(x[:, :100].contiguous(), dt[:, :100].contiguous(), A,
                   Bm[:, :100].contiguous(), Cm[:, :100].contiguous())


@pytest.mark.parametrize("seed", range(4))
def test_ssd_decode_step_matches_jax_and_chunked_equals_recurrence(seed):
    """``test_models.py``'s property on the port: the chunked scan equals
    the token-by-token recurrence, whose every step matches the JAX
    package's ``ssd_decode_step``."""
    rng = np.random.default_rng(100 + seed)
    l, chunk = int(rng.choice([8, 16, 32])), int(rng.choice([4, 8]))
    (x, dt, A, Bm, Cm), _ = _ssd_inputs(100 + seed, l=l, h=2, p=8, n=4)
    s_j = jnp.zeros((2, 2, 4, 8))
    s_t = torch.zeros(2, 2, 4, 8)
    ys = []
    for t in range(l):
        yj, s_j = jm.ssd_decode_step(*(jnp.asarray(a[:, t]) if a.ndim > 1
                                       else jnp.asarray(a)
                                       for a in (x, dt, A, Bm, Cm)), s_j)
        yt, s_t = tm.ssd_decode_step(*(torch.from_numpy(a[:, t]) if a.ndim > 1
                                       else torch.from_numpy(a)
                                       for a in (x, dt, A, Bm, Cm)), s_t)
        _close(yt, yj, what=f"y step {t}")
        _close(s_t, s_j, what=f"state step {t}")
        ys.append(yt)
    y_c, s_c = tms.ssd_chunked_plain(*map(torch.from_numpy,
                                          (x, dt, A, Bm, Cm)), chunk=chunk)
    np.testing.assert_allclose(y_c.numpy(), torch.stack(ys, 1).numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(s_c.numpy(), s_t.numpy(), atol=2e-4)


# ------------------------------------------------------------ the model ----

def _setup(mesh11, **dtypes):
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **dtypes)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **dtypes)
    params, _ = jm.init(jax.random.PRNGKey(6), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, np_params, rules_for(jcfg, mesh11)


def _tokens(cfg, seed, rows=2, seq=64):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(rows, seq)).astype(np.int32)


def test_param_count_matches_config():
    cfg = get_config(ARCH).reduced()
    params = tm.init(cfg, seed=0, device="cpu")
    assert sum(p.numel() for p in leaves(params)) == cfg.param_count()
    jcfg = jax_config(ARCH).reduced()
    jparams, _ = jm.init(jax.random.PRNGKey(0), jcfg)
    assert jax.tree_util.tree_structure(jparams) == \
        jax.tree_util.tree_structure(to_numpy_tree(params))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode", [False, True])
def test_mamba_block_matches_jax(compute, decode, mesh11):
    """One mamba block (layer 1 of the bridged stack): the chunked branch
    over 64 tokens, or one decode step from random conv and SSM states."""
    jcfg, cfg, params, np_params, rules = _setup(
        mesh11, compute_dtype=compute, kv_cache_dtype=compute)
    tparams = from_jax_params(np_params, cfg, device="cpu")
    jp = jax.tree_util.tree_map(lambda a: a[1], params["blocks"])
    tp = layer_slice(tparams["blocks"], 1)
    rng = np.random.default_rng(7)
    S = 1 if decode else 64
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    kw_j, kw_t = {}, {}
    if decode:
        ssm = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_state,
                                   cfg.ssm_head_dim), dtype=np.float32)
        conv = rng.standard_normal((2, cfg.ssm_conv - 1,
                                    cfg.d_inner + 2 * cfg.ssm_state),
                                   dtype=np.float32)
        kw_j = dict(ssm_state=jnp.asarray(ssm),
                    conv_state=jnp.asarray(conv).astype(compute),
                    decode=True)
        kw_t = dict(ssm_state=torch.from_numpy(ssm),
                    conv_state=torch.from_numpy(conv).to(
                        getattr(torch, compute)), decode=True)
    with mesh11:
        yj, (sj, cj) = jax.jit(lambda p, h: jm.mamba_block(
            p, jcfg, rules, h, **kw_j))(jp, jnp.asarray(x).astype(compute))
    with torch.no_grad():
        yt, (st, ct) = tm.mamba_block(tp, cfg, torch.from_numpy(x).to(
            getattr(torch, compute)), **kw_t)
    rel = REL if compute == "float32" else BF16_REL
    assert yt.dtype == getattr(torch, compute)
    _close(yt, np.asarray(yj.astype(jnp.float32)), rel, "y")
    _close(st, sj, rel, "ssm state")
    _close(ct, np.asarray(cj.astype(jnp.float32)), rel, "conv state")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_logits_match_jax(compute, mesh11):
    jcfg, cfg, params, np_params, rules = _setup(mesh11,
                                                 compute_dtype=compute)
    toks = _tokens(cfg, 8)
    with mesh11:
        lj, _ = jax.jit(lambda p, t: jm.forward(p, jcfg, rules, t))(
            params, jnp.asarray(toks))
    with torch.no_grad():
        lt, cache = tm.forward(from_jax_params(np_params, cfg, device="cpu"),
                               cfg, torch.from_numpy(toks))
    assert cache is None and lt.dtype == torch.float32
    _close(lt, lj, REL if compute == "float32" else BF16_REL, "logits")


def test_twelve_decode_steps_match_jax_carried_forward(mesh11):
    """12 greedy-fed decode steps over the carried cache (shared-block KV,
    SSM and conv states), logits and every cache leaf after each step."""
    jcfg, cfg, params, np_params, rules = _setup(mesh11, **F32)
    tparams = from_jax_params(np_params, cfg, device="cpu")
    B, MAX = 2, 16
    jcache = jm.init_cache(jcfg, B, MAX)
    tcache = tm.init_cache(cfg, B, MAX, device="cpu")
    step_j = jax.jit(lambda p, c, t, cl: jm.forward(
        p, jcfg, rules, t, cache=c, cache_len=cl))
    tok = _tokens(cfg, 9, rows=B, seq=1)
    cl = np.array([0, 3], np.int32)      # ragged rows
    for i in range(12):
        with mesh11:
            lj, jcache = step_j(params, jcache, jnp.asarray(tok),
                                jnp.asarray(cl))
        with torch.no_grad():
            lt, tcache = tm.forward(tparams, cfg, torch.from_numpy(tok),
                                    cache=tcache,
                                    cache_len=torch.from_numpy(cl))
        _close(lt, lj, what=f"logits step {i}")
        for name in ("ssm", "conv"):
            _close(tcache[name], jcache[name], what=f"{name} step {i}")
        _close(tcache["kv"]["k"], jcache["kv"]["k"], what=f"k step {i}")
        tok = np.asarray(lj).argmax(-1).astype(np.int32)
        cl = cl + 1


def test_prefill_step_matches_jax(mesh11):
    jcfg, cfg, params, np_params, rules = _setup(mesh11, **F32)
    toks = _tokens(cfg, 10)
    with mesh11:
        jl, jn = jax.jit(jsteps.make_prefill_step(jcfg, rules))(
            params, {"tokens": jnp.asarray(toks)})
    tl, tn = tsteps.make_prefill_step(cfg)(
        from_jax_params(np_params, cfg, device="cpu"),
        {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tn.dtype == torch.int32
    _close(tl, jl, what="logits")
    assert tn.tolist() == np.asarray(jn).tolist()


def _batch(cfg, seed, rows=4, seq=64):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(rows, seq + 1))
    labels = toks[:, 1:].copy()
    labels[:, :3] = tsteps.IGNORE
    np_batch = {"tokens": toks[:, :-1].astype(np.int32),
                "labels": labels.astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _assert_tree_close(got, want, rel=REL, atol=None, what=""):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b, np.float32)
        tol = atol if atol is not None else rel * max(np.abs(b).max(), 0.1)
        np.testing.assert_allclose(np.asarray(a, np.float32), b, atol=tol,
                                   rtol=0, err_msg=what)


def _assert_params_close(got, want, m_want):
    """Parameters after one AdamW step, each within PARAM_ATOL where its
    first moment |m| = 0.1 |g| (clipped) is at least M_MIN. The first step
    moves a parameter by lr * g / (|g| + eps), eps = 1e-8: where |g| is
    near eps, the gradients' agreement (REL of a leaf's largest, ~1e-6
    here) leaves that step anywhere in [-lr, lr]; from |g| = 1e-6 up it
    moves it by under a hundredth of lr. Elsewhere the step is held to the
    most one step can move a parameter, lr (1 + weight decay * |p|)."""
    lr, wd = TrainConfig().lr, TrainConfig().weight_decay
    for a, b, m in zip(*(jax.tree_util.tree_leaves(t)
                         for t in (got, want, m_want))):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        tol = np.where(np.abs(np.asarray(m)) >= M_MIN, PARAM_ATOL,
                       lr * (1 + wd * np.abs(b)) + PARAM_ATOL)
        assert (np.abs(a - b) <= tol).all(), np.abs(a - b).max()


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(remat, mesh11):
    """With remat "full" the port checkpoints each mamba layer (the
    reference's ``jax.checkpoint(inner)``); the gradients are the same."""
    jcfg, cfg, params, np_params, rules = _setup(mesh11, remat=remat, **F32)
    jb, tb = _batch(cfg, 11)
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
    _assert_tree_close(to_numpy_tree(tgrads), jgrads, what="grads")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches, mesh11):
    jcfg, cfg, params, np_params, rules = _setup(mesh11, **F32)
    jb, tb = _batch(cfg, 12)
    jts, jopt = jsteps.make_train_step(jcfg, rules, JTrainConfig(
        microbatches=microbatches))
    with mesh11:
        jp, jstate, jmet = jax.jit(jts)(params, jopt.init(params), jb)
    ts, opt = tsteps.make_train_step(cfg, TrainConfig(
        microbatches=microbatches))
    tparams = from_jax_params(np_params, cfg, device="cpu", master=True)
    tstate = opt.init(tparams)
    tp, _, tmet = ts(tparams, tstate, tb)
    for name in ("loss", "grad_norm", "nll"):
        np.testing.assert_allclose(tmet[name].item(), float(jmet[name]),
                                   atol=LOSS_ATOL, rtol=1e-5, err_msg=name)
    _assert_params_close(to_numpy_tree(tp), jp, jstate.m)
    _assert_tree_close(to_numpy_tree(tstate.m), jstate.m, what="m")
    _assert_tree_close(to_numpy_tree(tstate.v), jstate.v, what="v")


def test_train_step_takes_the_scan_it_is_given():
    """``ssd`` reaches every mamba layer of the no-cache forward (the
    smoke's kernels-vs-plain comparison relies on it), once per layer and
    microbatch, twice under remat."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), remat="full",
                              **F32)
    calls = []

    def counting(*a):
        calls.append(a[0].shape)
        return tms.ssd_chunked_plain(*a)
    _, tb = _batch(cfg, 13)
    params = tm.init(cfg, seed=0, device="cpu", master=True)
    ts, opt = tsteps.make_train_step(cfg, TrainConfig(microbatches=2),
                                     ssd=counting)
    ts(params, opt.init(params), tb)
    assert len(calls) == 2 * cfg.n_layers * 2
    assert calls[0] == (2, 64, cfg.ssm_heads, cfg.ssm_head_dim)


def test_registry_and_steps_take_the_hybrid_and_refuse_paged_decode():
    from repro_torch.models.registry import get_api
    cfg = get_config(ARCH).reduced()
    assert get_api(cfg).forward is tm.forward
    with pytest.raises(ValueError, match="not block-addressable"):
        tsteps.make_paged_serve_step(cfg)

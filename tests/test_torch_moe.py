"""The port's grouped matmul (K6/K6b's plain versions and the
``moe_gmm_apply`` bookkeeping) and its MoE FFN against the JAX package on
the CPU, on the same numpy-seeded inputs.

``gmm_plain`` against the Pallas ``gmm`` (interpret mode) and
``ops.moe_gmm_apply`` against the JAX one at ``test_kernels.py``'s shapes
and its skewed case; the plain backward against autograd of the plain
forward; ``moe_mlp`` against the JAX ``moe_mlp`` on reduced moonshot and
reduced arctic (dense residual) in float32 and bfloat16, with a router
skewed until the capacity drops assignments (the dropped set equal to the
reference's), with a zero router (every probability tied), and its
gradient against ``jax.grad``; ``load_balance_loss``; the kernel wrapper's
refusals."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import moe_gmm as jgm
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models.module import ParamBuilder as JParamBuilder
from repro.sharding import rules_for
from repro_torch.configs import get_config
from repro_torch.kernels import moe_gmm as tgm
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe
from repro_torch.models.module import ParamBuilder
from repro_torch.weights import from_jax_params, held_dtype

torch.set_num_threads(1)

# f32: the same f32 sums in another order (depths <= 256): 1e-5 of the
# output's largest |value|. bf16: both sides round the router logits, the
# dispatched rows' products and the combine to bf16 at the same points but
# sum in another order, so outputs may land a bf16 ulp apart: two ulps of
# the largest |value| (the outputs reach ~630 at these widths, the
# reference's fan-in init of the experts)
F32_REL = 1e-5


def _bf16_tol(want):
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 6)


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------- grouped matmul ----

@pytest.mark.parametrize("T,D,F,E,tile", [(512, 128, 256, 8, 128),
                                          (256, 256, 128, 4, 128),
                                          (384, 384, 256, 4, 128)])
def test_gmm_plain_matches_pallas_gmm(T, D, F, E, tile):
    """Every tile of sorted rows times its expert's weight, in f32."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, D), dtype=np.float32)
    w = 0.05 * rng.standard_normal((E, D, F), dtype=np.float32)
    tile_expert = rng.integers(0, E, size=T // tile).astype(np.int32)
    want = np.asarray(jgm.gmm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(tile_expert), tile_m=tile,
                              interpret=True))
    got = tgm.gmm_plain(_t(x), _t(w), _t(tile_expert), tile)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("T,D,F,E,tile", [(512, 128, 256, 8, 128),
                                          (256, 256, 128, 4, 128)])
def test_moe_gmm_apply_matches_jax(T, D, F, E, tile):
    """Sort, pad, per-tile expert ids and unsort: the JAX package's result
    (its Pallas gmm in interpret mode), and the per-token product."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((T, D), dtype=np.float32)
    w = 0.05 * rng.standard_normal((E, D, F), dtype=np.float32)
    eids = rng.integers(0, E, size=T).astype(np.int32)
    eids[eids == 1] = 2                  # expert 1 gets no token
    want = np.asarray(jops.moe_gmm_apply(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(eids), n_experts=E,
                                         tile_m=tile))
    got = tops.moe_gmm_apply(_t(x), _t(w), _t(eids), n_experts=E,
                             tile_m=tile)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.einsum("td,tdf->tf", x,
                                                      w[eids]), atol=2e-4)


def test_moe_gmm_apply_skewed_experts():
    """All tokens on one expert (``test_kernels.py``'s ragged extreme)."""
    rng = np.random.default_rng(7)
    T, D, F, E = 256, 64, 64, 8
    x = rng.standard_normal((T, D), dtype=np.float32)
    w = 0.05 * rng.standard_normal((E, D, F), dtype=np.float32)
    eids = np.full((T,), 3, np.int32)
    want = np.asarray(jops.moe_gmm_apply(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(eids), n_experts=E,
                                         tile_m=128))
    got = tops.moe_gmm_apply(_t(x), _t(w), _t(eids), n_experts=E)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), x @ w[3], atol=2e-4)


@pytest.mark.parametrize("tile_m", [4, 20, 128])
def test_gmm_plain_backward_matches_autograd(tile_m):
    """dx (the forward over the transposed weight) and dw (each expert's
    sum over its tiles; an expert without tiles gets zeros) against
    autograd of the plain forward, for tiles of any row count."""
    rng = np.random.default_rng(8)
    E, K, N, nt = 6, 64, 96, 5
    x = _t(rng.standard_normal((nt * tile_m, K), dtype=np.float32))
    w = _t(rng.standard_normal((E, K, N), dtype=np.float32))
    dy = _t(rng.standard_normal((nt * tile_m, N), dtype=np.float32))
    tile_expert = _t(np.array([3, 0, 3, 5, 0], np.int32))  # 1, 2, 4 unused
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    (tgm.gmm_plain(xr, wr, tile_expert, tile_m) * dy).sum().backward()
    dx, dw = tgm.gmm_backward_plain(x, w, tile_expert, tile_m, dy)
    torch.testing.assert_close(dx, xr.grad, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dw, wr.grad, rtol=1e-5, atol=1e-4)
    assert dw[[1, 2, 4]].abs().max() == 0
    # the autograd function on CPU tensors takes the same plain versions
    xr.grad = wr.grad = None
    (tops.gmm(xr, wr, tile_expert, tile_m) * dy).sum().backward()
    torch.testing.assert_close(xr.grad, dx)
    torch.testing.assert_close(wr.grad, dw)


@pytest.mark.parametrize("tile_m", [128, 200])
def test_gmm_plain_down_projection_matches_autograd(tile_m):
    """The down-projection's orientation (depth K > width N, as d_ff ->
    d_model) with tiles of 128 rows and of 200 (no multiple of the
    kernels' 128-row tiles, which the Pallas ``gmm`` does not take; the
    card holds its kernels to this plain version at that shape): the
    forward against each tile's product, dx and dw against autograd of
    the plain forward, with experts left without tiles."""
    rng = np.random.default_rng(9)
    E, K, N, nt = 4, 384, 256, 3
    x = rng.standard_normal((nt * tile_m, K), dtype=np.float32)
    w = 0.05 * rng.standard_normal((E, K, N), dtype=np.float32)
    dy = _t(rng.standard_normal((nt * tile_m, N), dtype=np.float32))
    tile_expert = np.array([2, 0, 2], np.int32)          # 1 and 3 unused
    got = tgm.gmm_plain(_t(x), _t(w), _t(tile_expert), tile_m)
    want = np.concatenate([x[t * tile_m:(t + 1) * tile_m] @ w[e]
                           for t, e in enumerate(tile_expert)])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    xr, wr = _t(x).requires_grad_(), _t(w).requires_grad_()
    (tgm.gmm_plain(xr, wr, _t(tile_expert), tile_m) * dy).sum().backward()
    dx, dw = tgm.gmm_backward_plain(_t(x), _t(w), _t(tile_expert), tile_m,
                                    dy)
    torch.testing.assert_close(dx, xr.grad, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dw, wr.grad, rtol=1e-5, atol=1e-4)
    assert dw[[1, 3]].abs().max() == 0


@pytest.mark.parametrize("case,exc", [
    ("depth", ValueError), ("columns", ValueError), ("rows", ValueError),
    ("ids", ValueError), ("dtype", TypeError), ("device", ValueError),
    ("alignment", ValueError),
])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(case, exc):
    """The wrapper's checks, which run before any launch, called on CPU
    tensors (a meta tensor stands for a second device)."""
    E, K, N, tm = 4, 64, 32, 8
    x = torch.zeros(4 * tm, K)
    w = torch.zeros(E, K, N)
    te = torch.zeros(4, dtype=torch.int32)
    if case == "depth":
        x, w = torch.zeros(4 * tm, 48), torch.zeros(E, 48, N)
    elif case == "columns":
        w = torch.zeros(E, K, 12)
    elif case == "rows":
        x = torch.zeros(4 * tm + 3, K)
    elif case == "ids":
        te = torch.zeros(4, dtype=torch.int64)
    elif case == "dtype":
        w = w.bfloat16()
    elif case == "device":
        te = torch.zeros(4, dtype=torch.int32, device="meta")
    elif case == "alignment":       # TMA reads from 16-byte boundaries
        x = torch.zeros(4 * tm * K + 2)[2:].view(4 * tm, K)
    with pytest.raises(exc):
        tgm._check(x, w, te, tm, False)


# ------------------------------------------------------------ moe_mlp ----

def _moe_params(arch, dtype, seed=3):
    """Reduced ``arch``'s MoE layer params from the JAX package (its
    ``init_moe``), with the port's serving weights bridged from them."""
    d = dict(params_dtype="float32", compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **d)
    cfg = dataclasses.replace(get_config(arch).reduced(), **d)
    pb = JParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    jmoe.init_moe(pb, jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, pb.params)
    return jcfg, cfg, np_params


def _jax_moe(jcfg, np_params, x, mesh11):
    dt = jnp.dtype(jcfg.compute_dtype)
    p = jax.tree_util.tree_map(jnp.asarray, np_params)
    with mesh11:
        y = jax.jit(lambda p, x: jmoe.moe_mlp(p, jcfg, rules_for(
            jcfg, mesh11), x))(p, jnp.asarray(x).astype(dt))
    return np.asarray(y.astype(jnp.float32))


def _port_moe(cfg, np_params, x, **kw):
    tp = from_jax_params(np_params, cfg, device="cpu")
    dt = getattr(torch, cfg.compute_dtype)
    with torch.no_grad():
        return tmoe.moe_mlp(tp, cfg, _t(x, dt), **kw).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"])
def test_moe_mlp_matches_jax(arch, dtype, mesh11):
    """Two groups of 64 tokens (capacity 40 of 4 experts, top-2); arctic
    adds its dense residual MLP. The kernel path's plain version gives the
    same as the default grouped matmul on CPU tensors."""
    jcfg, cfg, np_params = _moe_params(arch, dtype)
    x = np.random.default_rng(0).standard_normal((2, 64, cfg.d_model),
                                                 dtype=np.float32)
    want = _jax_moe(jcfg, np_params, x, mesh11)
    got = _port_moe(cfg, np_params, x)
    tol = F32_REL * np.abs(want).max() if dtype == "float32" \
        else _bf16_tol(want)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_array_equal(
        _port_moe(cfg, np_params, x, gmm=tgm.gmm_plain), got)


def _signature_experts(np_params, cfg):
    """Expert e writes only to output channel e (its wo maps every hidden
    unit to channel e): y[t, e] != 0 exactly where token t's assignment to
    expert e was kept."""
    wo = np.zeros_like(np_params["moe"]["wo"])
    for e in range(cfg.n_experts):
        wo[e, :, e] = 1.0 / cfg.d_ff
    np_params["moe"]["wo"] = wo
    for name in ("wi_gate", "wi_up"):     # with x >= 0: h_g, h_u > 0
        np_params["moe"][name] = np.abs(np_params["moe"][name])
    return np_params


def test_capacity_drops_the_reference_assignments(mesh11):
    """A router skewed so every token ranks experts 0 and 1 first: 128
    tokens in one group (capacity 80 per expert) put 128 first choices on
    expert 0 and 128 second choices on expert 1, so the last 48 tokens of
    each lose both. The kept set, read from signature experts, is the
    reference's, and ``moe.CountDrops`` counts the 96 drops."""
    jcfg, cfg, np_params = _moe_params("moonshot-v1-16b-a3b", "float32")
    np_params = _signature_experts(np_params, cfg)
    router = 0.01 * np.random.default_rng(1).standard_normal(
        np_params["moe"]["router"].shape).astype(np.float32)
    router[0, 0], router[0, 1] = 3.0, 2.0
    np_params["moe"]["router"] = router
    x = np.random.default_rng(2).standard_normal((1, 128, cfg.d_model),
                                                 dtype=np.float32)
    x[..., 0] = 4.0 + np.abs(x[..., 0])        # every token prefers 0, 1
    x[..., 1:] = np.abs(x[..., 1:])            # signatures need x >= 0
    want = _jax_moe(jcfg, np_params, x, mesh11)
    with tmoe.CountDrops() as drops:
        got = _port_moe(cfg, np_params, x)
    kept_j = np.abs(want[0, :, :cfg.n_experts]) > 1e-6
    kept_t = np.abs(got[0, :, :cfg.n_experts]) > 1e-6
    np.testing.assert_array_equal(kept_t, kept_j)
    assert kept_j.sum() == 2 * 80 and not kept_j[80:].any()
    assert drops.read() == 2 * 128 - kept_j.sum() == 96
    np.testing.assert_allclose(got, want, atol=F32_REL * np.abs(want).max())


def test_tied_probabilities_take_the_lowest_experts(mesh11):
    """A zero router makes every probability equal: the reference's top-k
    takes experts 0..k-1, and so does the port's stable sort."""
    jcfg, cfg, np_params = _moe_params("moonshot-v1-16b-a3b", "float32")
    np_params = _signature_experts(np_params, cfg)
    np_params["moe"]["router"] = np.zeros_like(np_params["moe"]["router"])
    x = np.abs(np.random.default_rng(3).standard_normal(
        (1, 8, cfg.d_model), dtype=np.float32))    # capacity 8: all kept
    want = _jax_moe(jcfg, np_params, x, mesh11)
    got = _port_moe(cfg, np_params, x)
    np.testing.assert_allclose(got, want, atol=F32_REL * np.abs(want).max())
    used = np.abs(got[..., :cfg.n_experts]) > 1e-6
    assert used[..., :cfg.top_k].all() and not used[..., cfg.top_k:].any()
    _, idx = tmoe.top_k(torch.full((16, cfg.n_experts), 0.25), cfg.top_k)
    assert (idx == torch.arange(cfg.top_k)).all()


def test_moe_mlp_gradients_match_jax(mesh11):
    """Autograd through the dispatch, the three grouped products (the
    plain backward of ``ops.gmm``), the gates and the router against
    ``jax.grad`` of the reference, in float32, for a loss <r, y>."""
    jcfg, cfg, np_params = _moe_params("arctic-480b", "float32", seed=4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32)
    r = rng.standard_normal(x.shape, dtype=np.float32)

    def jloss(p, x):
        return jnp.sum(jmoe.moe_mlp(p, jcfg, rules_for(jcfg, mesh11), x)
                       * jnp.asarray(r))
    with mesh11:
        jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(x))
    tp = from_jax_params(np_params, cfg, device="cpu", master=True)
    leaves = {("moe", n): tp["moe"][n] for n in tp["moe"]}
    leaves.update({("dense_mlp", n): tp["dense_mlp"][n]
                   for n in tp["dense_mlp"]})
    for t in leaves.values():
        t.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    (tmoe.moe_mlp(tp, cfg, xt) * _t(r)).sum().backward()
    want = np.asarray(jgx)
    np.testing.assert_allclose(xt.grad.numpy(), want,
                               atol=F32_REL * np.abs(want).max())
    for (sub, name), t in leaves.items():
        want = np.asarray(jg[sub][name])
        np.testing.assert_allclose(t.grad.numpy(), want,
                                   atol=F32_REL * np.abs(want).max(),
                                   err_msg=f"{sub}/{name}")


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 16, 8), dtype=np.float32)
    gate_idx = rng.integers(0, 8, size=(2, 16, 2)).astype(np.int32)
    want = float(jmoe.load_balance_loss(jnp.asarray(logits),
                                        jnp.asarray(gate_idx), 8))
    got = tmoe.load_balance_loss(_t(logits), _t(gate_idx), 8).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_init_moe_builds_the_reference_tree():
    """The port's layer holds the reference's leaves at its shapes (arctic
    with its dense residual MLP), in the serving dtypes: the router and
    the experts in the compute dtype."""
    for arch in ("moonshot-v1-16b-a3b", "arctic-480b"):
        cfg = get_config(arch).reduced()
        pb = ParamBuilder(0, lambda path: held_dtype(path, cfg), "cpu")
        tmoe.init_moe(pb, cfg)
        _, _, np_params = _moe_params(arch, "bfloat16")
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, pb.params)) == \
            jax.tree_util.tree_structure(
                jax.tree_util.tree_map(lambda a: 0, np_params))
        for sub in pb.params:
            for name, t in pb.params[sub].items():
                assert tuple(t.shape) == np_params[sub][name].shape
                assert t.dtype == torch.bfloat16, (sub, name)

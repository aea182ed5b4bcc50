"""AdamW's two routes (``optim.adamw``): the hand-written kernels
(``kernels.adamw``) for plain float32 CUDA leaves, the eager update for
everything else. On the CPU: the route each kind of leaf takes and the
counters that show it, the kernels' arithmetic (their plain version)
against the eager route, and the division by the microbatches folded into
the update against dividing first. The kernels against the eager route on
the card are a ``cuda`` test; the kernels' arithmetic against the JAX
package is ``test_torch_train.py``'s. No JAX here: the card test runs on
the GPU machine with ``python -m pytest tests/test_torch_adamw.py -m cuda
--noconftest``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as K
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import leaves

torch.set_num_threads(1)

HP = dict(lr=1e-2, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
          grad_clip=1.0)
SHAPES = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 4)}, "e": (1,)}


def _tree(rng, scale=1.0, shapes=SHAPES, device="cpu"):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v, device) for k, v in shapes.items()}
    return torch.from_numpy(
        rng.standard_normal(shapes, dtype=np.float32) * scale).to(device)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _kernel_step(opt, grads, state, params):
    """The kernels' arithmetic (their plain version), called as
    ``AdamW.update`` calls the kernels."""
    gs = leaves(grads)
    gnorm = K.adamw_sqnorm_plain(gs, opt.microbatches)
    K.adamw_update_plain(leaves(params), gs, leaves(state.m),
                         leaves(state.v), state.count, gnorm,
                         divisor=opt.microbatches, **HP)
    return gnorm


# ------------------------------------------------------------- routes ----

def _dtensors(tree, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    if isinstance(tree, dict):
        return {k: _dtensors(v, mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, [Replicate()])


@pytest.mark.parametrize("kind", ["cpu", "dtensor", "bf16_moments"])
def test_leaves_the_kernels_do_not_take_go_the_plain_route(kind):
    """CPU tensors, DTensors (one fake rank) and bf16 moments take the
    eager route: ``plain_leaves`` counts every leaf, ``fused_leaves``
    none, and no kernel launches."""
    from repro_torch.launch import mesh as tmesh
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng, 3.0)
    opt = AdamW(**HP, moments_dtype=("bfloat16" if kind == "bf16_moments"
                                     else "float32"))
    if kind == "dtensor":
        from torch.distributed.device_mesh import init_device_mesh
        tmesh.fake_world(1)
        mesh = init_device_mesh("cpu", (1,))
        params, grads = _dtensors(params, mesh), _dtensors(grads, mesh)
    try:
        state = opt.init(params)
        before = (AdamW.fused_leaves, AdamW.plain_leaves,
                  K.adamw_sqnorm.launches, K.adamw_update.launches)
        opt.update(grads, state, params)
        after = (AdamW.fused_leaves, AdamW.plain_leaves,
                 K.adamw_sqnorm.launches, K.adamw_update.launches)
    finally:
        if kind == "dtensor":
            tmesh.release_world()
    assert [b - a for a, b in zip(before, after)] == [0, 4, 0, 0]
    assert state.count.item() == 1


def _refused(kind):
    """A leaf table (p, g, m, v), its count and its norm, with one thing
    the kernels do not take: ``kind``."""
    rng = np.random.default_rng(2)
    tables = [leaves(_tree(rng)) for _ in range(4)]
    count = torch.zeros((), dtype=torch.int32)
    gnorm = torch.ones(())
    if kind == "bf16_moment":
        tables[2][1] = tables[2][1].to(torch.bfloat16)
    elif kind == "non_contiguous":
        tables[0][0] = tables[0][0].t()
    elif kind == "misaligned":
        tables[1][2] = torch.empty(tables[1][2].numel() + 1)[1:].view(
            tables[1][2].shape)
    elif kind == "shapes_differ":
        tables[3][0] = tables[3][0].reshape(-1)
    elif kind == "tables_differ":
        tables[3] = tables[3][:-1]
    elif kind == "count_int64":
        count = count.long()
    elif kind == "gnorm_not_0d":
        gnorm = gnorm.reshape(1)
    return tables, count, gnorm


REFUSED = {"cpu": "CUDA device", "bf16_moment": "float32",
           "non_contiguous": "contiguous", "misaligned": "aligned",
           "shapes_differ": "shape", "tables_differ": "one length",
           "count_int64": "count", "gnorm_not_0d": "gnorm"}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refusal_names_what_the_kernels_do_not_take(kind):
    """The one rule behind the route and the wrappers' refusals names the
    first thing the kernels do not take; the device comes last, so every
    other fault shows on CPU tensors too."""
    tables, count, gnorm = _refused(kind)
    assert REFUSED[kind] in K.refusal(tables, count, gnorm)


@pytest.mark.parametrize("kind", ["cpu", "non_contiguous"])
def test_the_wrappers_raise_on_what_the_kernels_do_not_take(kind):
    """The wrappers raise with :func:`refusal`'s reason, and count no
    launch; they have no CPU branch."""
    (ps, gs, ms, vs), count, gnorm = _refused(kind)
    before = (K.adamw_sqnorm.launches, K.adamw_update.launches)
    with pytest.raises(ValueError, match=REFUSED[kind]):
        K.adamw_update(ps, gs, ms, vs, count, gnorm, **HP)
    with pytest.raises(ValueError, match="CUDA device"):
        K.adamw_sqnorm(gs, 2)
    assert (K.adamw_sqnorm.launches, K.adamw_update.launches) == before


# ----------------------------------------------- the kernels' arithmetic --

@pytest.mark.parametrize("clip", ["engaged", "not_engaged"])
@pytest.mark.parametrize("microbatches", [1, 3])
def test_kernel_arithmetic_matches_the_plain_route(clip, microbatches):
    """Three steps of the kernels' arithmetic against the eager route on
    the same leaves. They differ only in the norm's summation (per leaf
    sums of squares against per leaf norms squared) and so, where the clip
    engages, in the scale's last bits. The eager norm squares each leaf's
    rounded norm (two roundings more a leaf): the norm to 1e-6 of itself,
    moments to 1e-6 of the leaf's largest, parameters to 1e-6 of lr and
    an ulp of the leaf's largest (a step a bit apart can round p the other
    way)."""
    rng = np.random.default_rng(3)
    scale = 3.0 if clip == "engaged" else 0.01
    opt = AdamW(**HP, microbatches=microbatches)
    p_k = _tree(rng)
    p_e = _clone(p_k)
    s_k, s_e = opt.init(p_k), opt.init(p_e)
    for _ in range(3):
        g = _tree(rng, scale * microbatches)
        n_k = _kernel_step(opt, _clone(g), s_k, p_k)
        _, _, n_e = opt.update_plain(_clone(g), s_e, p_e)
        assert (n_k.item() > 1) == (clip == "engaged")
        np.testing.assert_allclose(n_k.item(), n_e.item(), rtol=1e-6)
    for got, want, is_p in ((p_k, p_e, True), (s_k.m, s_e.m, False),
                            (s_k.v, s_e.v, False)):
        for a, b in zip(leaves(got), leaves(want)):
            big = b.abs().max().item()
            atol = 1e-6 * HP["lr"] + 2.0 ** -23 * big if is_p else 1e-6 * big
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=atol)
    assert s_k.count.item() == s_e.count.item() == 3


@pytest.mark.parametrize("route", ["kernel_arithmetic", "plain_route"])
def test_the_divisor_folded_in_matches_dividing_first(route):
    """``microbatches=3`` on summed gradients gives the same bits as
    dividing the gradients by 3 first and updating with
    ``microbatches=1``: the update divides each element first, as the
    train step used to."""
    rng = np.random.default_rng(4)
    g_sum = _tree(rng, 6.0)
    g_div = _clone(g_sum)
    for t in leaves(g_div):
        t.div_(3)
    out = []
    for mb, g in ((3, g_sum), (1, g_div)):
        opt = AdamW(**HP, microbatches=mb)
        params = _tree(np.random.default_rng(5))
        state = opt.init(params)
        if route == "kernel_arithmetic":
            gnorm = _kernel_step(opt, _clone(g), state, params)
        else:
            _, _, gnorm = opt.update(_clone(g), state, params)
        out.append((gnorm, leaves(params) + leaves(state.m)
                    + leaves(state.v)))
    (n3, t3), (n1, t1) = out
    assert torch.equal(n3, n1)
    assert all(torch.equal(a, b) for a, b in zip(t3, t1))


def test_the_kernel_arithmetic_leaves_the_gradients_alone():
    """The kernels read the gradients and write nothing there (the eager
    route divides and scales them in place)."""
    rng = np.random.default_rng(6)
    opt = AdamW(**HP, microbatches=2)
    params, grads = _tree(rng), _tree(rng, 5.0)
    kept = _clone(grads)
    _kernel_step(opt, grads, opt.init(params), params)
    assert all(torch.equal(a, b) for a, b in zip(leaves(grads),
                                                 leaves(kept)))


# ------------------------------------------------------------- the card --

# leaves of odd lengths (1, 7 and 4099 = 4k + 3 elements take the scalar
# tail), a 2.1 GB one (2^29 + 3 elements) and 70 in all, so the table
# takes two launches of at most 64
CARD_SIZES = [1, 7, 4099, 4096, (1 << 29) + 3] + [33 + i for i in range(65)]


def _card_tree(gen, sizes, scale, dev):
    return {f"l{i:03d}": torch.randn(n, generator=gen, device=dev) * scale
            for i, n in enumerate(sizes)}


@pytest.mark.cuda
def test_kernels_match_the_plain_route_on_the_card():
    """Three steps (the clip engaged in the first two, not in the third;
    2 microbatches) of the kernels against the eager route on copies of
    the same leaves. Tolerances: the norm sums 5e8 squares in another
    order (per thread, then per block, against PyTorch's reduction), so it
    is held to 1e-5 of itself, and the clip scale with it; every other
    operation rounds as the eager route's does, so v is held to 2e-5 of
    its size (the scale squared), m (whose terms may cancel) to 2e-5 of
    its leaf's largest, and parameters to 2^-21 of theirs plus 4e-5 of lr
    (the step's part). A second run on the same
    inputs gives the same bits, a leaf the kernels do not take sends the
    step the eager route, and the wrappers refuse it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    opt = AdamW(**HP, microbatches=2)
    p0 = _card_tree(gen, CARD_SIZES, 1.0, dev)
    grads = [_card_tree(gen, CARD_SIZES, s, dev) for s in (1e-2, 1e-3, 1e-8)]
    p_k, p_r, p_e = _clone(p0), _clone(p0), _clone(p0)
    s_k, s_r, s_e = opt.init(p_k), opt.init(p_r), opt.init(p_e)
    fused, launches = AdamW.fused_leaves, K.adamw_update.launches
    for step, g in enumerate(grads):
        _, _, n_k = opt.update(g, s_k, p_k)
        _, _, n_r = opt.update(g, s_r, p_r)
        _, _, n_e = opt.update_plain(_clone(g), s_e, p_e)
        assert torch.equal(n_k, n_r)
        np.testing.assert_allclose(n_k.item(), n_e.item(), rtol=1e-5)
        assert (n_e.item() > 1) == (step < 2)
    assert AdamW.fused_leaves - fused == 6 * len(CARD_SIZES)
    assert K.adamw_update.launches - launches == 6
    assert s_k.count.item() == s_e.count.item() == 3
    for a, r, e in zip(leaves(p_k) + leaves(s_k.m) + leaves(s_k.v),
                       leaves(p_r) + leaves(s_r.m) + leaves(s_r.v),
                       leaves(p_e) + leaves(s_e.m) + leaves(s_e.v)):
        assert torch.equal(a, r)
    for got, want, kind in ((p_k, p_e, "p"), (s_k.m, s_e.m, "m"),
                            (s_k.v, s_e.v, "v")):
        for a, e in zip(leaves(got), leaves(want)):
            tol = {"p": lambda: 2.0 ** -21 * e.abs() + 4e-5 * HP["lr"],
                   "m": lambda: 2e-5 * e.abs().max(),
                   "v": lambda: 2e-5 * e.abs()}[kind]()
            assert bool(((a - e).abs() <= tol).all()), (
                (a - e).abs().max().item())
    del p_r, s_r
    g = grads[0]
    bf16 = AdamW(**HP, moments_dtype="bfloat16")
    plain = AdamW.plain_leaves
    bf16.update(_clone(g), bf16.init(p_e), p_e)
    assert AdamW.plain_leaves - plain == len(CARD_SIZES)
    # a leaf the kernels do not take sends the step the eager route (the
    # wrappers would raise on it)
    odd = {"t": torch.randn(6, 5, generator=gen, device=dev).t()}
    opt.update({"t": odd["t"].clone()}, opt.init(odd), odd)
    assert AdamW.plain_leaves - plain == len(CARD_SIZES) + 1
    ps = leaves(p_k)[:3]
    with pytest.raises(ValueError):
        K.adamw_sqnorm([t.to(torch.bfloat16) for t in ps])
    with pytest.raises(ValueError):
        K.adamw_sqnorm([torch.empty(9, device=dev)[1:]])
    with pytest.raises(ValueError):
        K.adamw_sqnorm(list(odd.values()))

"""The port's no-cache attention against the JAX package: the plain flash
attention forward and backward (what the K3a/K3b CUDA kernels are held to
on the GPU by ``chip_smoke.py``) against ``layers.flash_attention_xla``,
the Pallas ``flash_attention`` in interpret mode (forward, its lse, and
``jax.vjp``) and torch autograd through a naive attention, on the shapes of
``tests/test_kernels.py``; the differentiable ``ops.flash_attention``
against ``jax.grad`` of the Pallas op and against autograd; the Pallas tail
at S = 192 (a deliberate difference, ROADMAP Queue 3); non-causal attention
of 128 queries over 256 keys at hd 64 (an encoder-decoder's
cross-attention, cut to whole Pallas tiles); and what the kernel wrappers
refuse, with the shapes and strides they compute for the launches. Inputs
come from numpy with a seed; the same arrays go to both packages in the
port's layout [B,S,H,hd] (transposed for Pallas' [B,H,S,hd])."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

# (B, H, KV, S, hd, Pallas block_q, block_k, causal, dtype): test_kernels.py
SHAPES = [
    (2, 4, 2, 256, 64, 128, 128, True, "float32"),
    (1, 4, 4, 128, 32, 64, 64, False, "float32"),
    (1, 8, 2, 256, 128, 128, 64, True, "float32"),
    (2, 4, 1, 128, 64, 64, 128, True, "bfloat16"),
]
IDS = [f"B{s[0]}H{s[1]}KV{s[2]}S{s[3]}hd{s[4]}-{'causal' if s[7] else 'full'}"
       f"-{s[8]}" for s in SHAPES]
# f32: sums over <= 256 keys in another order than XLA's or the Pallas
# interpreter's. bf16 outputs: rounded once from f32 sums whose weights
# are rounded at other points (the Pallas kernel keeps p in f32), held to
# 2e-2 of the largest |output|; lse is f32 from exact bf16 products.
F32_ATOL = 2e-5
BF16_REL = 2e-2
GRAD_F32_ATOL = 5e-5


def _inputs(B, H, KV, S, hd, dtype, seed=0, Skv=None):
    """q, k, v, do in both packages' dtype, same values: numpy f32 rounded
    once to ``dtype``. Returns (jax arrays, torch tensors), [B,S,*,hd]
    (k and v over ``Skv`` positions when given)."""
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    shapes = [(B, S, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd),
              (B, S, H, hd)]
    jx = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(
        jnp.dtype(dtype)) for s in shapes]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _t(a):
    """[B,S,H,hd] <-> [B,H,S,hd]."""
    return jnp.transpose(a, (0, 2, 1, 3))


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def _close(got, want, dtype, atol=F32_ATOL):
    got, want = _np(got), _np(want)
    tol = atol if dtype == "float32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _naive(q, k, v, causal):
    """Attention written out in torch, f32, differentiable: [B,S,H,hd]."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kk = k.float().repeat_interleave(G, dim=2)
    vv = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * hd ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)


@pytest.mark.parametrize("B,H,KV,S,hd,bq,bk,causal,dtype", SHAPES, ids=IDS)
def test_plain_forward_matches_xla_and_pallas(B, H, KV, S, hd, bq, bk,
                                              causal, dtype):
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(B, H, KV, S, hd, dtype)
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, causal=causal)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    _close(o, jlayers.flash_attention_xla(jq, jk, jv, causal=causal), dtype)
    po, plse = jfa.flash_attention_fwd(_t(jq), _t(jk), _t(jv), causal=causal,
                                       block_q=bq, block_k=bk, interpret=True)
    _close(o, _t(po), dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(plse), atol=F32_ATOL)
    # the layer's plain path is the same function
    _close(tlayers.flash_attention_xla(tq, tk, tv, causal=causal), o, dtype)


@pytest.mark.parametrize("B,H,KV,S,hd,bq,bk,causal,dtype", SHAPES, ids=IDS)
def test_plain_backward_matches_pallas_vjp(B, H, KV, S, hd, bq, bk, causal,
                                           dtype):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(B, H, KV, S, hd, dtype)
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, causal=causal)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                        causal=causal)
    _, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(
        q, k, v, causal, bq, bk, True), _t(jq), _t(jk), _t(jv))
    for g, w, name in zip(got, vjp(_t(jdo)), "qkv"):
        assert g.dtype == tq.dtype, name
        _close(g, _t(w), dtype, atol=GRAD_F32_ATOL)


@pytest.mark.parametrize("B,H,KV,S,hd,bq,bk,causal,dtype", SHAPES, ids=IDS)
def test_plain_backward_matches_torch_autograd(B, H, KV, S, hd, bq, bk,
                                               causal, dtype):
    _, (tq, tk, tv, tdo) = _inputs(B, H, KV, S, hd, dtype)
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, causal=causal)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                        causal=causal)
    leaves = [x.float().requires_grad_(True) for x in (tq, tk, tv)]
    _naive(*leaves, causal).backward(tdo.float())
    for g, x in zip(got, leaves):
        _close(g, x.grad, dtype, atol=GRAD_F32_ATOL)


def test_autograd_function_matches_jax_grad_of_pallas():
    """``ops.flash_attention`` (the reference's custom_vjp as an
    autograd.Function) against jax.grad of the Pallas op, as
    test_kernels.py's grads test sets it up."""
    B, H, KV, S, hd = 1, 4, 2, 256, 64
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(B, H, KV, S, hd,
                                                    "float32", seed=1)

    def loss(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, True, 128, 128, True)
                       * _t(jdo))
    want = jax.grad(loss, argnums=(0, 1, 2))(_t(jq), _t(jk), _t(jv))
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    (tops.flash_attention(*leaves, causal=True) * tdo).sum().backward()
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(_t(w)),
                                   atol=GRAD_F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_naive_autograd(causal):
    _, (tq, tk, tv, tdo) = _inputs(2, 6, 2, 96, 32, "float32", seed=2)
    got = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    want = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    o = tops.flash_attention(*got, causal=causal)
    o_ref = _naive(*want, causal)
    np.testing.assert_allclose(o.detach().numpy(), o_ref.detach().numpy(),
                               atol=F32_ATOL)
    o.backward(tdo)
    o_ref.backward(tdo)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=GRAD_F32_ATOL)


def test_plain_covers_the_tail_pallas_leaves_unwritten():
    """S = 192 with 128-row tiles: the Pallas grid has 192 // 128 = 1 query
    tile and 1 key tile, so rows 128-191 of its output are never written
    and keys 128-191 never attended. The port (plain version and kernels)
    computes every row over every key: rows 0-127 of a causal attention
    see only keys 0-127, so there the two agree."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(1, 4, 2, 192, 64, "float32",
                                               seed=3)
    o, _ = tfa.flash_attention_fwd_plain(tq, tk, tv, causal=True)
    np.testing.assert_allclose(o.numpy(), _naive(tq, tk, tv, True).numpy(),
                               atol=F32_ATOL)
    po, _ = jfa.flash_attention_fwd(_t(jq), _t(jk), _t(jv), causal=True,
                                    interpret=True)
    po = np.asarray(_t(po))
    np.testing.assert_allclose(o.numpy()[:, :128], po[:, :128], atol=F32_ATOL)
    assert not np.allclose(o.numpy()[:, 128:], po[:, 128:], atol=1e-2)


def test_attention_layer_takes_the_autograd_function_by_default(monkeypatch):
    """The no-cache branch of ``layers.attention`` attends through
    ``ops.flash_attention`` unless ``attend`` says otherwise."""
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, causal=True):
        calls.append((tuple(q.shape), causal))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(tops, "flash_attention", spy)
    from repro_torch.configs import get_config
    from repro_torch.models import module
    cfg = get_config("starcoder2-7b").reduced()
    pb = module.ParamBuilder(0, lambda _: torch.float32, "cpu")
    tlayers.init_attention(pb, cfg)
    x = torch.randn(2, 5, cfg.d_model)
    step = tlayers.nocache_step(cfg, torch.arange(5).expand(2, 5))
    y = tlayers.attention(pb.params["attn"], cfg, x, step=step)
    y_plain = tlayers.attention(pb.params["attn"], cfg, x, step=step,
                                attend=tlayers.flash_attention_xla)
    assert calls == [((2, 5, cfg.n_heads, cfg.hd), True)]
    np.testing.assert_allclose(y.numpy(), y_plain.numpy(), atol=F32_ATOL)


@pytest.mark.parametrize("case,exc", [
    ("hd48", ValueError), ("causal-ragged", ValueError),
    ("mixed-dtype", TypeError), ("kv-not-dividing", ValueError),
    ("non-contiguous", ValueError), ("hd48-bfloat16", ValueError)])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(case, exc):
    """The checks a CUDA tensor meets before a launch (run here on CPU
    tensors: the checks do not depend on the device). hd 48 is refused in
    both dtypes: bf16 takes the wgmma kernels at hd 32, 64, 80 and 128
    only."""
    q = torch.zeros(1, 8, 4, 64)
    k = v = torch.zeros(1, 8, 2, 64)
    causal = True
    if case.startswith("hd48"):
        dt = torch.bfloat16 if case.endswith("bfloat16") else torch.float32
        q, k, v = torch.zeros(1, 8, 4, 48, dtype=dt), \
            torch.zeros(1, 8, 2, 48, dtype=dt), \
            torch.zeros(1, 8, 2, 48, dtype=dt)
    elif case == "causal-ragged":
        k = v = torch.zeros(1, 16, 2, 64)
    elif case == "mixed-dtype":
        k = k.to(torch.bfloat16)
    elif case == "kv-not-dividing":
        k = v = torch.zeros(1, 8, 3, 64)
    else:
        q = torch.zeros(1, 4, 8, 64).transpose(1, 2)
    with pytest.raises(exc):
        tfa._check(q, k, v, causal, (q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_at_the_hybrid_head_dim_matches_xla(dtype):
    """zamba2's shared block: hd 80 with G = 1 (H = KV), causal. The plain
    forward matches ``flash_attention_xla`` and its backward ``jax.vjp``
    of it; the kernel wrappers take hd 80."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(1, 4, 4, 128, 80, dtype)
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, causal=True)
    want, vjp = jax.vjp(lambda q, k, v: jlayers.flash_attention_xla(
        q, k, v, causal=True), jq, jk, jv)
    _close(o, want, dtype)
    grads = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                          causal=True)
    for g, w in zip(grads, vjp(jdo)):
        _close(g, w, dtype, atol=GRAD_F32_ATOL)
    assert tfa._check(tq, tk, tv, True, (tq, tk, tv)) == (1, 128, 4, 80)


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_at_the_reduced_head_dim_matches_xla(dtype, causal):
    """The reduced configs' attention: hd 32, H 4 over KV 2 (G = 2), S 200
    (no multiple of a tile). The plain forward matches
    ``flash_attention_xla`` (f32 to 2e-5; bf16 to 2e-2 of the largest
    |output|, the weights rounded at other points) and its backward
    ``jax.vjp`` of it (f32 to 5e-5); the kernel wrappers take hd 32 (the
    wgmma kernels in bf16, the split-TF32 kernels in f32, each with
    per-head partials of dk and dv that ``fa_dkv_reduce`` sums over the G
    heads)."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(1, 4, 2, 200, 32, dtype,
                                                    seed=9)
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, causal=causal)
    want, vjp = jax.vjp(lambda q, k, v: jlayers.flash_attention_xla(
        q, k, v, causal=causal), jq, jk, jv)
    _close(o, want, dtype)
    grads = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                          causal=causal)
    for g, w in zip(grads, vjp(jdo)):
        _close(g, w, dtype, atol=GRAD_F32_ATOL)
    assert tfa._check(tq, tk, tv, causal, (tq, tk, tv)) == (1, 200, 4, 32)
    _, partial = tfa.bwd_scratch(tq, tk)
    assert tuple(partial.shape) == (2, 1, 200, 4, 32)


# cross-attention: Sq 128 over Skv 256, H = KV = 4, hd 64, non-causal, in
# whole Pallas tiles (block_q 64, block_k 128: Pallas drops a partial one)
CROSS = (1, 4, 4, 128, 256, 64, 64, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_cross_attention_matches_xla_and_pallas(dtype):
    """Non-causal attention with Sq != Skv, the shape the card's phase 6
    checks the kernels at (seamless-m4t-medium's cross-attention, cut): the
    plain forward against ``flash_attention_xla`` and the Pallas forward in
    interpret mode (o and lse), its backward against ``jax.vjp`` of both."""
    B, H, KV, Sq, Skv, hd, bq, bk = CROSS
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(B, H, KV, Sq, hd, dtype,
                                                    seed=4, Skv=Skv)
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, causal=False)
    assert o.shape == (B, Sq, H, hd) and lse.shape == (B, H, Sq)
    want, xla_vjp = jax.vjp(lambda q, k, v: jlayers.flash_attention_xla(
        q, k, v, causal=False), jq, jk, jv)
    _close(o, want, dtype)
    po, plse = jfa.flash_attention_fwd(_t(jq), _t(jk), _t(jv), causal=False,
                                       block_q=bq, block_k=bk, interpret=True)
    _close(o, _t(po), dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(plse), atol=F32_ATOL)
    grads = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                          causal=False)
    _, pallas_vjp = jax.vjp(lambda q, k, v: jops.flash_attention(
        q, k, v, False, bq, bk, True), _t(jq), _t(jk), _t(jv))
    for g, w, pw, x in zip(grads, xla_vjp(jdo), pallas_vjp(_t(jdo)),
                           (tq, tk, tv)):
        assert g.shape == x.shape and g.dtype == x.dtype
        _close(g, w, dtype, atol=GRAD_F32_ATOL)
        _close(g, _t(pw), dtype, atol=GRAD_F32_ATOL)


@pytest.mark.parametrize("Sq,Skv", [(128, 256), (1000, 333), (1, 4096)])
def test_wrappers_take_cross_attention_shapes(Sq, Skv):
    """The bf16 kernels' checks (their TMA strides included) take
    non-causal Sq != Skv, ragged or not, at every head dim, and refuse it
    causal, as the mma.sync kernels' did: the new wrappers refuse no input
    the old ones took."""
    for hd in tfa.HEAD_DIMS:
        q = torch.zeros(1, Sq, 4, hd, dtype=torch.bfloat16)
        k = torch.zeros(1, Skv, 2, hd, dtype=torch.bfloat16)
        assert tfa._check(q, k, k, False, (q, k, k)) == (1, Sq, 4, hd)
        with pytest.raises(ValueError):
            tfa._check(q, k, k, True, (q, k, k))


@pytest.mark.parametrize("shape,itemsize,want", [
    ((1, 4096, 36, 128), 2, (256, 9216, 37748736)),
    ((2, 1000, 32, 80), 2, (160, 5120, 5120000)),
    ((1, 128, 4, 64), 2, (128, 512, 65536)),
    ((3, 5, 1, 64), 4, (256, 256, 1280)),
    ((8, 64, 4, 32), 2, (64, 256, 16384))])
def test_tma_strides_of_the_kernels_tensor_maps(shape, itemsize, want):
    """The byte strides (head, row, batch row) of the 4-D tensor map over a
    contiguous [B, S, N, hd] tensor (the last: the reduced configs' q at
    hd 32, in the training example's batch of 8 rows of 64)."""
    assert tfa.tma_strides(shape, itemsize) == want


@pytest.mark.parametrize("shape,itemsize", [
    ((1, 8, 4, 36), 2), ((1, 8, 1, 4), 2), ((1, 8, 2, 4), 1)])
def test_tma_strides_refuse_what_tma_does_not_take(shape, itemsize):
    """A stride that is not a multiple of 16 bytes raises before a launch
    (hd 36 in bf16: 72-byte heads; 8-byte heads; 4-byte heads)."""
    with pytest.raises(ValueError, match="multiples of 16"):
        tfa.tma_strides(shape, itemsize)


@pytest.mark.parametrize("Sq,dtype,want", [
    (4096, torch.bfloat16, 4096), (1000, torch.bfloat16, 1024),
    (1, torch.bfloat16, 128), (129, torch.bfloat16, 256),
    (1000, torch.float32, 1000), (4096, torch.float32, 4096)])
def test_stats_pitch(Sq, dtype, want):
    """The backward's lse/delta rows: padded to the bf16 kernels' 128-row
    tiles (a multiple of 16 bytes, as their TMA map needs), Sq for f32."""
    assert tfa.stats_pitch(Sq, dtype) == want


@pytest.mark.parametrize("dtype,H,KV,partial_shape", [
    (torch.bfloat16, 8, 2, (2, 2, 100, 8, 64)),
    (torch.bfloat16, 4, 4, (0,)),
    (torch.float32, 8, 2, (2, 2, 100, 8, 64)),
    (torch.bfloat16, 4, 2, (2, 2, 100, 4, 32)),
    (torch.float32, 4, 4, (0,))])
def test_bwd_scratch_shapes(dtype, H, KV, partial_shape):
    """Scratch of the backward: stats [2, B, H, pitch] f32 always; the f32
    partials of dk and dv per query head only with G > 1, in both dtypes
    and at every head dim (the fourth case: the reduced configs' H 4 over
    KV 2 at hd 32).
    The head dim is the partials' last where there are partials, else 64."""
    hd = partial_shape[-1] if len(partial_shape) == 5 else 64
    q = torch.zeros(2, 60, H, hd, dtype=dtype)
    k = torch.zeros(2, 100, KV, hd, dtype=dtype)
    stats, partial = tfa.bwd_scratch(q, k)
    assert stats.shape == (2, 2, H, tfa.stats_pitch(60, dtype))
    assert stats.dtype == partial.dtype == torch.float32
    assert tuple(partial.shape) == partial_shape


def test_backward_takes_delta_from_the_unrounded_output():
    """Cross-attention of 64 queries over 512 keys and values that differ
    little (an encoder output that varies little over its positions), in
    bf16. dS = p (dP - delta) cancels against delta = rowsum(do * o); the
    reference takes delta from o rounded to bf16, which moves it by 2^-9
    of |o| |do|, and dq and dk come out wrong at full size. The
    differentiable ``ops.flash_attention`` keeps the forward's float32
    output for its backward: dq's and dk's errors against float64 autograd
    fall more than tenfold, dk's under 1e-2; dv does not depend on delta."""
    g = torch.Generator().manual_seed(5)
    B, Sq, Skv, H, KV, hd = 2, 64, 512, 4, 2, 64
    common = torch.randn(1, 1, KV, hd, generator=g) * 2
    q = torch.randn(B, Sq, H, hd, generator=g).to(torch.bfloat16)
    k, v = ((common + 0.05 * torch.randn(B, Skv, KV, hd, generator=g))
            .to(torch.bfloat16) for _ in range(2))
    do = torch.randn(B, Sq, H, hd, generator=g).to(torch.bfloat16)
    exact = [t.double().requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention_fwd_plain(*exact, causal=False)[0].backward(
        do.double())
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tops.flash_attention(*got, causal=False).backward(do)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=False)
    rounded = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=False)

    def rel(a, want):
        return ((a.double() - want.grad).norm() / want.grad.norm()).item()
    for a, b, want in zip(got[:2], rounded[:2], exact[:2]):
        assert rel(a.grad, want) < rel(b, want) / 10
    assert rel(got[1].grad, exact[1]) < 1e-2
    assert torch.equal(got[2].grad, rounded[2])

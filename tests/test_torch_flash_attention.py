"""The port's no-cache attention against the JAX package: the plain flash
attention forward and backward (what the K3a/K3b CUDA kernels are held to
on the GPU by ``chip_smoke.py``) against ``layers.flash_attention_xla``,
the Pallas ``flash_attention`` in interpret mode (forward, its lse, and
``jax.vjp``) and torch autograd through a naive attention, on the shapes
of ``tests/test_kernels.py``; the differentiable ``ops.flash_attention``
against ``jax.grad`` of the Pallas op and against autograd; the Pallas
tail at S = 192 (a deliberate difference, ROADMAP Queue 3); and what the
kernel wrappers refuse. Inputs come from numpy with a seed; the same
arrays go to both packages in the port's layout [B,S,H,hd] (transposed
for Pallas' [B,H,S,hd])."""
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


def _inputs(B, H, KV, S, hd, dtype, seed=0):
    """q, k, v, do in both packages' dtype, same values: numpy f32 rounded
    once to ``dtype``. Returns (jax arrays, torch tensors), [B,S,*,hd]."""
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)]
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
    ("hd32", ValueError), ("causal-ragged", ValueError),
    ("mixed-dtype", TypeError), ("kv-not-dividing", ValueError),
    ("non-contiguous", ValueError)])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(case, exc):
    """The checks a CUDA tensor meets before a launch (run here on CPU
    tensors: the checks do not depend on the device)."""
    q = torch.zeros(1, 8, 4, 64)
    k = v = torch.zeros(1, 8, 2, 64)
    causal = True
    if case == "hd32":
        q, k, v = torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 2, 32), \
            torch.zeros(1, 8, 2, 32)
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

"""The port's model layers against the JAX package's, at reduced widths in
float32: rmsnorm, rope, both MLPs, the paged branch of attention (K/V
append into the block arena + attention through the block table) and the
carried-cache branch (two-part attention, then the write at cache_len).
Inputs and weights come from numpy with a seed; the same arrays go to
both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as jl
from repro.sharding import rules_for
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

ATOL = 3e-5     # float32, sums in another order than XLA's
F32 = dict(params_dtype="float32", compute_dtype="float32",
           kv_cache_dtype="float32")


def _cfgs(arch):
    return (dataclasses.replace(jax_config(arch).reduced(), **F32),
            dataclasses.replace(get_config(arch).reduced(), **F32))


def _normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def test_rmsnorm_matches():
    rng = np.random.default_rng(0)
    x, s = _normal(rng, 3, 5, 64), _normal(rng, 64)
    want = jl.rmsnorm(jnp.asarray(x), jnp.asarray(s))
    got = tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("theta", [1e4, 1e5, 1e6])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 3, 4, 32)
    pos = rng.integers(0, 4000, size=(2, 3)).astype(np.int32)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ["qwen2-72b", "starcoder2-7b"])
def test_mlp_matches(arch, mesh11):
    """swiglu (qwen2) and the 2-matrix tanh-GELU MLP (starcoder2)."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(2)
    D, F = cfg.d_model, cfg.d_ff
    p = {"wi_up": _normal(rng, D, F) * D ** -0.5,
         "wo": _normal(rng, F, D) * F ** -0.5}
    if cfg.mlp_kind == "swiglu":
        p["wi_gate"] = _normal(rng, D, F) * D ** -0.5
    x = _normal(rng, 2, 3, D)
    want = jl.mlp({k: jnp.asarray(v) for k, v in p.items()},
                  rules_for(jcfg, mesh11), jnp.asarray(x))
    got = tl.mlp(from_jax_params(p, cfg, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ["qwen2-72b", "starcoder2-7b"])
def test_paged_attention_branch_matches(arch, mesh11):
    """One token per row: the new K/V lands at each row's block-table slot
    (inactive row parks in the null block) and the output attends
    through the table with lens = cache_len + 1."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(3)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L, NB, BS, MB, B = 2, 12, 4, 3, 3
    p = {"wq": _normal(rng, D, H, hd) * D ** -0.5,
         "wk": _normal(rng, D, KV, hd) * D ** -0.5,
         "wv": _normal(rng, D, KV, hd) * D ** -0.5,
         "wo": _normal(rng, H, hd, D) * (H * hd) ** -0.5}
    if cfg.qkv_bias:
        p.update(bq=_normal(rng, H, hd), bk=_normal(rng, KV, hd),
                 bv=_normal(rng, KV, hd))
    kp, vp = _normal(rng, L, NB, BS, KV, hd), _normal(rng, L, NB, BS, KV, hd)
    bt = np.asarray([[3, 7, 1], [5, 2, 0], [0, 0, 0]], np.int32)
    cache_len = np.asarray([9, 4, 0], np.int32)    # row 2 is inactive
    x = _normal(rng, B, 1, D)
    pos = cache_len[:, None]
    li = 1
    jout, (jk, jv) = jl.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg,
        rules_for(jcfg, mesh11), jnp.asarray(x), positions=jnp.asarray(pos),
        cache_len=jnp.asarray(cache_len),
        paged_cache=(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt), li))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    step = tl.paged_step(cfg, torch.from_numpy(pos),
                         torch.from_numpy(cache_len), torch.from_numpy(bt), BS)
    assert step.slots.tolist() == [1 * BS + 1, 2 * BS + 0, 0]
    tout = tl.attention(
        from_jax_params(p, cfg, device="cpu"), cfg, torch.from_numpy(x),
        step=step, paged_cache=(tk, tv, torch.from_numpy(bt), li))
    np.testing.assert_allclose(tout.numpy()[:2], np.asarray(jout)[:2],
                               atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    # the active rows' writes landed where the block tables say
    assert not np.allclose(tk.numpy()[li, 1, 1], kp[li, 1, 1])    # 9 -> 1:1
    assert not np.allclose(tk.numpy()[li, 2, 0], kp[li, 2, 0])    # 4 -> 2:0


@pytest.mark.parametrize("arch", ["qwen2-72b", "starcoder2-7b"])
def test_carried_attention_branch_matches(arch, mesh11):
    """One token per row against the carried cache [L,B,S,KV,hd]: the
    output attends the cache below cache_len plus the token itself, the
    token lands at [layer, b, cache_len[b]], and the row at cache_len = S
    drops its write instead of spilling into the next row."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(4)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L, B, S = 2, 3, 8
    p = {"wq": _normal(rng, D, H, hd) * D ** -0.5,
         "wk": _normal(rng, D, KV, hd) * D ** -0.5,
         "wv": _normal(rng, D, KV, hd) * D ** -0.5,
         "wo": _normal(rng, H, hd, D) * (H * hd) ** -0.5}
    if cfg.qkv_bias:
        p.update(bq=_normal(rng, H, hd), bk=_normal(rng, KV, hd),
                 bv=_normal(rng, KV, hd))
    kc, vc = _normal(rng, L, B, S, KV, hd), _normal(rng, L, B, S, KV, hd)
    cache_len = np.asarray([5, 0, S], np.int32)     # row 2 is full
    x = _normal(rng, B, 1, D)
    pos = cache_len[:, None]
    li = 1
    jout, (jk, jv) = jl.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg,
        rules_for(jcfg, mesh11), jnp.asarray(x), positions=jnp.asarray(pos),
        cache_len=jnp.asarray(cache_len),
        carried_cache=(jnp.asarray(kc), jnp.asarray(vc), li))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    step = tl.dense_step(cfg, torch.from_numpy(pos),
                         torch.from_numpy(cache_len), S)
    assert step.slots.tolist() == [0 * S + 5, 1 * S + 0, B * S]
    assert step.lens.tolist() == cache_len.tolist()
    tout = tl.attention(
        from_jax_params(p, cfg, device="cpu"), cfg, torch.from_numpy(x),
        step=step, carried_cache=(tk, tv, li))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    written = np.argwhere((tk.numpy() != kc).any(axis=(3, 4)))
    assert written.tolist() == [[li, 0, 5], [li, 1, 0]]   # row 2 dropped

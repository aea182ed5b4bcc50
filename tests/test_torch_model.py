"""The port's serve steps against the JAX package's on bridged weights, on
reduced starcoder2-7b (tanh-GELU MLP, GQA) and reduced qwen2-72b (qkv
bias): the paged step (several single-token steps over a shared block
arena) and the dense-cache step (12 single-token steps over a carried
cache with ragged per-row lengths, one row past capacity). Next tokens
equal and caches allclose in float32; int8 and bf16 cases held to stated
tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jtr
from repro.models.registry import get_api
from repro.sharding import rules_for
from repro.train.steps import make_paged_serve_step as jax_step
from repro.train.steps import make_serve_step as jax_dense_step
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as ttr
from repro_torch.train.steps import make_paged_serve_step, make_serve_step
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(params_dtype="float32", compute_dtype="float32",
           kv_cache_dtype="float32")
NB, BS = 16, 4
BT = np.asarray([[3, 9, 4, 0], [7, 1, 12, 5], [0, 0, 0, 0]], np.int32)
CL0 = np.asarray([2, 5, 0], np.int32)        # row 2 is an inactive slot


def _setup(arch, mesh11, **dtypes):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **dtypes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **dtypes)
    params, _ = get_api(jcfg).init(jax.random.PRNGKey(4), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    return jcfg, cfg, params, tparams, rules_for(jcfg, mesh11)


def _arenas(cfg, rng):
    """Both packages' arenas holding the same random KV history."""
    shape = (cfg.n_layers, NB, BS, cfg.n_kv_heads, cfg.hd)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    dt = jnp.dtype(cfg.kv_cache_dtype)
    jar = {"k": jnp.asarray(k).astype(dt), "v": jnp.asarray(v).astype(dt)}
    tar = {n: torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, cfg.kv_cache_dtype)) for n, a in jar.items()}
    return jar, tar


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-72b"])
def test_paged_serve_steps_match_jax_f32(arch, mesh11):
    jcfg, cfg, params, tparams, rules = _setup(arch, mesh11, **F32)
    rng = np.random.default_rng(6)
    jar, tar = _arenas(cfg, rng)
    jstep = jax.jit(jax_step(jcfg, rules))
    tstep = make_paged_serve_step(cfg)
    cl = CL0.copy()
    with mesh11:
        for _ in range(6):
            tok = rng.integers(1, cfg.vocab_size, size=(3, 1)).astype(np.int32)
            jn, jar = jstep(params, jar, jnp.asarray(BT), jnp.asarray(tok),
                            jnp.asarray(cl))
            tn, tar = tstep(tparams, tar, torch.from_numpy(BT),
                            torch.from_numpy(tok), torch.from_numpy(cl))
            assert tn.dtype == torch.int32
            assert tn.tolist()[:2] == np.asarray(jn).tolist()[:2]
            cl[:2] += 1
    for n in ("k", "v"):
        np.testing.assert_allclose(tar[n].numpy(), np.asarray(jar[n]),
                                   atol=1e-5)


def test_paged_forward_logits_match_jax_bf16(mesh11):
    """bf16 weights, activations and arena: the two packages round at
    different places (XLA's CPU bf16 dots and GELU vs PyTorch's f32
    accumulation and f32 GELU), so logits (std ~1 at these widths) are
    held to 0.05 absolute: about 6 bf16 ulps at 1, three times the
    0.016 this seed shows."""
    dt = dict(params_dtype="float32", compute_dtype="bfloat16",
              kv_cache_dtype="bfloat16")
    jcfg, cfg, params, tparams, rules = _setup("starcoder2-7b", mesh11, **dt)
    rng = np.random.default_rng(7)
    jar, tar = _arenas(cfg, rng)
    tok = rng.integers(1, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    with mesh11:
        jl, _ = jtr.forward(params, jcfg, rules, jnp.asarray(tok),
                            cache_len=jnp.asarray(CL0),
                            paged_cache=(jar["k"], jar["v"], jnp.asarray(BT)))
    tl, _ = ttr.forward(tparams, cfg, torch.from_numpy(tok),
                        cache_len=torch.from_numpy(CL0),
                        paged_cache=(tar["k"], tar["v"], torch.from_numpy(BT)))
    assert tl.dtype == torch.float32 and tl.shape == (3, 1, cfg.padded_vocab)
    diff = np.abs(tl.numpy()[:2] - np.asarray(jl)[:2]).max()
    assert diff <= 0.05, diff


def test_port_init_is_seeded_and_held_in_compute_dtype():
    cfg = dataclasses.replace(get_config("starcoder2-7b").reduced(),
                              compute_dtype="bfloat16")
    a = ttr.init(cfg, seed=3, device="cpu")
    b = ttr.init(cfg, seed=3, device="cpu")
    c = ttr.init(cfg, seed=4, device="cpu")
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert not torch.equal(a["blocks"]["attn"]["wq"],
                           c["blocks"]["attn"]["wq"])
    assert a["blocks"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd)
    assert a["blocks"]["mlp"]["wi_up"].dtype == torch.bfloat16
    assert a["blocks"]["ln_attn"].dtype == torch.float32   # norms: f32
    assert "wi_gate" not in a["blocks"]["mlp"]               # gelu MLP
    # layers draw from their own name-keyed generators
    assert not torch.equal(a["blocks"]["attn"]["wq"][0],
                           a["blocks"]["attn"]["wq"][1])
    std = a["blocks"]["mlp"]["wi_up"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_paged_step_rejects_moe():
    with pytest.raises(ValueError, match="later slice"):
        make_paged_serve_step(get_config("moonshot-v1-16b-a3b").reduced())


# ------------------------------------------------- dense-cache serve step ----

S_DENSE = 16
# ragged rows: row 2 crosses capacity at step 6, row 3 starts full, so
# their writes drop while they still attend the whole cache and the token
CL_DENSE = np.asarray([0, 3, 10, S_DENSE], np.int32)


def _dense_caches(cfg, rng):
    """Both packages' carried caches [L,B,S,KV,hd] holding the same random
    history (int8: random integers)."""
    shape = (cfg.n_layers, len(CL_DENSE), S_DENSE, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        k, v = (rng.integers(-127, 128, size=shape, dtype=np.int8)
                for _ in range(2))
        return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                {"k": torch.from_numpy(k), "v": torch.from_numpy(v)})
    k, v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    dt = jnp.dtype(cfg.kv_cache_dtype)
    jc = {"k": jnp.asarray(k).astype(dt), "v": jnp.asarray(v).astype(dt)}
    tc = {n: torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, cfg.kv_cache_dtype)) for n, a in jc.items()}
    return jc, tc


def _run_dense(arch, mesh11, dtypes, n_steps=12, seed=8):
    """Feed n_steps tokens one at a time through both dense serve steps.
    Returns (next tokens per step of jax, of the port; final caches of
    jax, of the port; logits of the last step of jax, of the port; the
    port's caches before the first step)."""
    jcfg, cfg, params, tparams, rules = _setup(arch, mesh11, **dtypes)
    rng = np.random.default_rng(seed)
    jc, tc = _dense_caches(cfg, rng)
    tc0 = {n: t.clone() for n, t in tc.items()}
    jstep = jax.jit(jax_dense_step(jcfg, rules))
    tstep = make_serve_step(cfg)
    cl = CL_DENSE.copy()
    jtoks, ttoks = [], []
    with mesh11:
        for _ in range(n_steps):
            tok = rng.integers(1, cfg.vocab_size,
                               size=(len(cl), 1)).astype(np.int32)
            jn, jc = jstep(params, jc, jnp.asarray(tok), jnp.asarray(cl))
            tn, tc2 = tstep(tparams, tc, torch.from_numpy(tok),
                            torch.from_numpy(cl))
            assert tn.dtype == torch.int32 and tc2["k"] is tc["k"]
            jtoks.append(np.asarray(jn).tolist())
            ttoks.append(tn.tolist())
            cl = cl + 1
        jl, _ = jtr.forward(params, jcfg, rules, jnp.asarray(tok),
                            cache=jc, cache_len=jnp.asarray(cl))
    tl, _ = ttr.forward(tparams, cfg, torch.from_numpy(tok),
                        cache_len=torch.from_numpy(cl),
                        cache={n: t.clone() for n, t in tc.items()})
    return jtoks, ttoks, jc, tc, np.asarray(jl), tl.numpy(), tc0


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-72b"])
def test_dense_serve_steps_match_jax_f32(arch, mesh11):
    jtoks, ttoks, jc, tc, jl, tl, tc0 = _run_dense(arch, mesh11, F32)
    assert ttoks == jtoks
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5)
    # the rows at capacity dropped their writes: row 2 wrote positions
    # 10-15 only, row 3 nothing
    written = (tc["k"] != tc0["k"]).any(dim=-1).any(dim=-1).any(dim=0)
    assert written[2].nonzero().flatten().tolist() == list(range(10, 16))
    assert not written[3].any()


def test_dense_serve_steps_match_jax_int8_cache(mesh11):
    """int8 cache, f32 compute: the written token is quantised by
    clip(round(k * QSCALE)), identically in both packages except where
    k * QSCALE lands within f32 rounding of a .5 (none at this seed), and
    attended unquantised."""
    dt = dict(F32, kv_cache_dtype="int8")
    jtoks, ttoks, jc, tc, jl, tl, _ = _run_dense("starcoder2-7b", mesh11,
                                                 dt)
    assert ttoks == jtoks
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))


def test_dense_forward_logits_match_jax_bf16(mesh11):
    """bf16 compute and cache over 12 steps: the packages round at
    different places (as in the paged bf16 case), so the last step's
    logits are held to 0.05 and the caches to two bf16 ulps for |x| < 8
    (0.0625); greedy tokens may then differ on near ties, so they are not
    compared."""
    dt = dict(params_dtype="float32", compute_dtype="bfloat16",
              kv_cache_dtype="bfloat16")
    _, _, jc, tc, jl, tl, _ = _run_dense("starcoder2-7b", mesh11, dt)
    assert np.abs(tl - jl).max() <= 0.05, np.abs(tl - jl).max()
    for n in ("k", "v"):
        np.testing.assert_allclose(
            tc[n].float().numpy(), np.asarray(jc[n].astype(jnp.float32)),
            atol=0.0625)


def test_dense_step_with_plain_attend_is_the_default_on_cpu():
    cfg = dataclasses.replace(get_config("starcoder2-7b").reduced(), **F32)
    params = ttr.init(cfg, seed=1, device="cpu")
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    cl = torch.tensor([3, 0], dtype=torch.int32)
    outs = []
    for attend in (None, tops.decode_attention_plain):
        cache = ttr.init_cache(cfg, 2, 8, device="cpu")
        assert cache["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                    cfg.hd)
        outs.append(make_serve_step(cfg, attend=attend)(params, cache, tok,
                                                        cl))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1]["k"], outs[1][1]["k"])


def test_dense_step_rejects_other_families():
    with pytest.raises(ValueError, match="other-families slice"):
        make_serve_step(get_config("seamless-m4t-medium").reduced())

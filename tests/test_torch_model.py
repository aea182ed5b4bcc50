"""The port's paged serve step against the JAX package's on bridged
weights: several single-token steps over a shared block arena, next
tokens equal and arenas allclose in float32, on reduced starcoder2-7b
(tanh-GELU MLP, GQA) and reduced qwen2-72b (qkv bias), plus one bf16 case
held to a stated logits tolerance."""
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
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttr
from repro_torch.train.steps import make_paged_serve_step
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

"""The MoE family (reduced moonshot-v1-16b-a3b) through the port's steps,
serving, checkpointing and launchers, against the JAX package on the CPU.

The paged serve step (a batch with an inactive slot, whose garbage token
the capacity counts in both packages), the dense-cache serve step, the
prefill step and the train step (one and two microbatches) against
``repro.train.steps`` on bridged weights in float32; dense UDP serving
against the JAX ``_greedy_decode``; the model's parameter count; the
serving dtypes of the leaves the reference reads as float32 (with the
encoder-decoder's norms, a repaired fault of the weight bridge); an MoE
training state crossing between the two packages' ``CheckpointManager``
in both directions; both launchers, ``--continuous`` included."""
import dataclasses
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_config
from repro.models import encdec as jencdec
from repro.models import transformer as jtr
from repro.optim import AdamW as JAdamW
from repro.serving.server import _greedy_decode as jax_greedy_decode
from repro.sharding import rules_for
from repro.train import steps as jsteps
from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
from repro_torch.config import Family, TrainConfig
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import get_api
from repro_torch.optim import OptState
from repro_torch.serving.server import CpuBaselineUdpServer, GenesysUdpServer
from repro_torch.train import steps as tsteps
from repro_torch.weights import from_jax_params, to_numpy_tree
from test_torch_dense_serve import _serve_requests
from test_torch_serve import _free_udp_port, _port_is_bound
from test_torch_train import LOSS_ATOL, PARAM_ATOL, _assert_tree_close, _batch

torch.set_num_threads(1)

ARCH = "moonshot-v1-16b-a3b"
F32 = dict(params_dtype="float32", compute_dtype="float32",
           kv_cache_dtype="float32")
NB, BS = 16, 4
BT = np.asarray([[3, 9, 4, 0], [7, 1, 12, 5], [0, 0, 0, 0]], np.int32)
CL0 = np.asarray([2, 5, 0], np.int32)        # row 2 is an inactive slot
MAX_LEN = 32


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **F32)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **F32)
    params, _ = jtr.init(jax.random.PRNGKey(4), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, np_params


def test_registry_takes_moe():
    cfg = get_config(ARCH).reduced()
    api = get_api(cfg)
    assert api.forward is ttr.forward and api.init is ttr.init
    assert cfg.family == Family.MOE and Family.MOE in ttr.DECODER_FAMILIES
    params = api.init(cfg, seed=0, device="cpu")
    assert params["blocks"]["moe"]["wi_gate"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert "mlp" not in params["blocks"]


def test_parameter_count():
    """The port's tree holds ``param_count()`` parameters (reduced), and
    the full config counts 28.06 B, 3.98 B of them active per token (the
    reference's ``test_models.py`` count)."""
    cfg = get_config(ARCH).reduced()
    params = ttr.init(cfg, seed=0, device="cpu")
    assert sum(t.numel() for t in flatten(params)) == cfg.param_count()
    full = get_config(ARCH)
    assert abs(full.param_count() - 28.06e9) < 0.01e9
    assert abs(full.active_param_count() - 3.98e9) < 0.01e9


def _arenas(cfg, rng):
    shape = (cfg.n_layers, NB, BS, cfg.n_kv_heads, cfg.hd)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def test_paged_serve_steps_match_jax(model, mesh11):
    """Six single-token steps over a shared arena: next tokens of the live
    rows equal and arenas allclose."""
    jcfg, cfg, params, np_params = model
    tparams = from_jax_params(np_params, cfg, device="cpu")
    rng = np.random.default_rng(6)
    jar, tar = _arenas(cfg, rng)
    jstep = jax.jit(jsteps.make_paged_serve_step(jcfg,
                                                 rules_for(jcfg, mesh11)))
    tstep = tsteps.make_paged_serve_step(cfg)
    cl = CL0.copy()
    with mesh11:
        for _ in range(6):
            tok = rng.integers(1, cfg.vocab_size, size=(3, 1)).astype(
                np.int32)
            jn, jar = jstep(params, jar, jnp.asarray(BT), jnp.asarray(tok),
                            jnp.asarray(cl))
            tn, tar = tstep(tparams, tar, torch.from_numpy(BT),
                            torch.from_numpy(tok), torch.from_numpy(cl))
            assert tn.tolist()[:2] == np.asarray(jn).tolist()[:2]
            cl[:2] += 1
    for n in ("k", "v"):
        np.testing.assert_allclose(tar[n].numpy(), np.asarray(jar[n]),
                                   atol=1e-5)


def test_dense_serve_steps_match_jax(model, mesh11):
    """Eight steps of three rows over a carried cache of 8 positions, one
    row starting at capacity (its writes drop): tokens and caches."""
    jcfg, cfg, params, np_params = model
    tparams = from_jax_params(np_params, cfg, device="cpu")
    rng = np.random.default_rng(7)
    S = 8
    jcache = jtr.init_cache(jcfg, 3, S)
    tcache = ttr.init_cache(cfg, 3, S, device="cpu")
    jstep = jax.jit(jsteps.make_serve_step(jcfg, rules_for(jcfg, mesh11)))
    tstep = tsteps.make_serve_step(cfg)
    cl = np.asarray([0, 3, S], np.int32)
    with mesh11:
        for _ in range(8):
            tok = rng.integers(1, cfg.vocab_size, size=(3, 1)).astype(
                np.int32)
            jn, jcache = jstep(params, jcache, jnp.asarray(tok),
                               jnp.asarray(cl))
            tn, tcache = tstep(tparams, tcache, torch.from_numpy(tok),
                               torch.from_numpy(cl))
            assert tn.tolist() == np.asarray(jn).tolist()
            cl = np.minimum(cl + 1, S)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   atol=1e-5)


def test_prefill_step_matches_jax(model, mesh11):
    """Four rows of 16 tokens: 64 tokens in one group, capacity 40 of 4
    experts, top-2."""
    jcfg, cfg, params, np_params = model
    jb, tb = _batch(cfg, np.random.default_rng(5), ignore=False)
    with mesh11:
        jl, jn = jax.jit(jsteps.make_prefill_step(
            jcfg, rules_for(jcfg, mesh11)))(params, jb)
    tl, tn = tsteps.make_prefill_step(cfg)(
        from_jax_params(np_params, cfg, device="cpu", master=True), tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    assert tn.tolist() == np.asarray(jn).tolist()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(model, mesh11, microbatches):
    """Loss, grad norm, updated parameters and moments (the router and
    the experts' gradients through the dispatch, the grouped products and
    the gates), as ``test_torch_train.py`` holds the dense families."""
    jcfg, cfg, params, np_params = model
    rules = rules_for(jcfg, mesh11)
    jb, tb = _batch(cfg, np.random.default_rng(2))
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


def test_moe_udp_serving_matches_jax_greedy_decode(model, mesh11, tgsys):
    """Eager (tenants) and the CPU baseline answer every request with the
    JAX package's tokens (one row: T = 1, capacity 4, nothing dropped)."""
    jcfg, cfg, params, np_params = model
    tparams = from_jax_params(np_params, cfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(1, 6, size=3)]
    serve_j = jax.jit(jsteps.make_serve_step(jcfg, rules_for(jcfg, mesh11)))
    with mesh11:
        want = [jax_greedy_decode(serve_j, params,
                                  jtr.init_cache(jcfg, 1, MAX_LEN),
                                  jnp.zeros((1,), jnp.int32),
                                  np.asarray(p, np.int32), 4)
                for p in prompts]
    serve = tsteps.make_serve_step(cfg)
    cache = ttr.init_cache(cfg, 1, MAX_LEN, device="cpu")
    srv = GenesysUdpServer(tgsys, port=0, max_batch=4, payload=256,
                           batch_window_s=0.05, use_tenants=True)
    eager = _serve_requests(
        tgsys.table._sockets[srv.fd].getsockname()[1],
        lambda rp: srv.serve_model(serve, tparams, cache, n_batches=50,
                                   n_requests=3, reply_port=rp,
                                   max_tokens=4),
        prompts, n_replies=3)
    srv.close()
    assert sorted(eager) == sorted(want)
    cpu = CpuBaselineUdpServer(port=0)
    baseline = _serve_requests(
        cpu.sock.getsockname()[1],
        lambda rp: cpu.serve_model(serve, tparams, cache, n_batches=3,
                                   reply_port=rp, max_tokens=4),
        prompts, n_replies=3)
    cpu.close()
    assert sorted(baseline) == sorted(want)


@pytest.fixture()
def tgsys():
    from repro_torch.core.genesys import Genesys, GenesysConfig
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    yield g
    g.shutdown()


def _leaf(tree, path):
    for name in path.split("/"):
        tree = tree[name]
    return tree


@pytest.mark.parametrize("arch,f32_leaves,compute_leaves", [
    ("seamless-m4t-medium",
     ("decoder/ln_self", "decoder/ln_cross", "decoder/ln_mlp",
      "encoder/ln_attn", "encoder/ln_mlp", "enc_norm", "final_norm"),
     ("decoder/self_attn/wq", "decoder/cross_attn/wk", "encoder/mlp/wo",
      "lm_head", "embed")),
    (ARCH,
     ("blocks/ln_attn", "blocks/ln_mlp", "final_norm"),
     ("blocks/moe/router", "blocks/moe/wi_gate", "blocks/moe/wi_up",
      "blocks/moe/wo", "blocks/attn/wq", "embed", "lm_head")),
])
def test_serving_weights_hold_the_float32_leaves_in_float32(
        arch, f32_leaves, compute_leaves):
    """Bridged from the JAX package's init: the norm scales, which
    ``rmsnorm`` reads as float32 (the encoder-decoder's ``ln_self``,
    ``ln_cross`` and ``enc_norm`` included), stay in float32; the MoE
    router, which the reference casts to the compute dtype before its
    einsum, is held in it with the experts."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    init = jencdec.init if arch == "seamless-m4t-medium" else jtr.init
    jparams, _ = init(jax.random.PRNGKey(0), jcfg)
    bridged = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu")
    for path in f32_leaves:
        assert _leaf(bridged, path).dtype == torch.float32, path
    for path in compute_leaves:
        assert _leaf(bridged, path).dtype == torch.bfloat16, path


def _train_state(seed):
    """Reduced moonshot's parameters and an AdamW state in both packages,
    the same values."""
    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams, _ = jtr.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    jstate = dataclasses.replace(
        JAdamW().init(jparams),
        m=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape, dtype=np.float32)), jparams),
        v=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.random(p.shape, dtype=np.float32)), jparams),
        count=jnp.asarray(5, jnp.int32))

    def bridge(tree):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg,
                               device="cpu", master=True)
    tstate = OptState(m=bridge(jstate.m), v=bridge(jstate.v),
                      count=torch.tensor(5, dtype=torch.int32))
    return ({"params": jparams, "opt": jstate},
            {"params": bridge(jparams), "opt": tstate})


def _zeros(tree):
    if isinstance(tree, OptState):
        return OptState(_zeros(tree.m), _zeros(tree.v),
                        torch.zeros_like(tree.count))
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_jax_checkpoint_of_the_moe_tree_restores_into_the_port(
        gsys, tgsys, tmp_path):
    jtree, ttree = _train_state(0)
    JCheckpointManager(gsys, str(tmp_path)).save(2, jtree)
    got = CheckpointManager(tgsys, str(tmp_path)).restore(2, _zeros(ttree))
    g, w = flatten(got), flatten(ttree)
    assert len(g) == len(w) == len(jax.tree_util.tree_leaves(jtree))
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_of_the_moe_tree_restores_into_jax(
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
        np.asarray(got["params"]["blocks"]["moe"]["wo"]),
        to_numpy_tree(ttree["params"])["blocks"]["moe"]["wo"])


def test_launcher_trains_moe_then_resumes(tmp_path, capsys):
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "32", "--ckpt-dir",
            str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    st = launch_train.main(args)
    assert st.steps == 2 and st.ckpts == 1
    assert all(np.isfinite(l) for l in st.losses)
    st = launch_train.main(args + ["--resume", "--steps", "1"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert st.steps == 1 and all(np.isfinite(l) for l in st.losses)


@pytest.mark.parametrize("flags", [[], ["--continuous"]],
                         ids=["dense", "continuous"])
def test_launcher_serves_moe(flags, capsys):
    """``python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b``
    on the CPU: the dense cache, and continuous batching over the paged
    arena, each answering two requests with their budgets."""
    port = _free_udp_port()
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.bind(("127.0.0.1", 0))
    client.settimeout(60)
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--port",
            str(port), "--reply-port", str(client.getsockname()[1]),
            "--batches", "2", "--max-tokens", "5", "--per-request-tokens",
            *flags]
    th = threading.Thread(target=launch_serve.main, args=(argv,),
                          daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    while not _port_is_bound(port):  # the server binds it once built
        assert time.monotonic() < deadline and th.is_alive()
        time.sleep(0.02)
    reqs = [[3, 31, 5, 9], [2, 32, 7]]
    replies = []
    try:
        for r in reqs:
            client.sendto(np.asarray(r, np.int32).tobytes(),
                          ("127.0.0.1", port))
            data, _ = client.recvfrom(4096)
            replies.append(np.frombuffer(data, np.int32).tolist())
    finally:
        client.close()
    th.join(60)
    assert not th.is_alive()
    assert [(r[0], len(r) - 1) for r in replies] == [(31, 3), (32, 2)]
    assert "requests=2" in capsys.readouterr().out

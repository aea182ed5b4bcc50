"""The hybrid family (reduced zamba2-2.7b) through the port's serving,
checkpointing and launchers, against the JAX package on the CPU.

Dense-cache serving of every server (GENESYS eager, bucketed, and the CPU
baseline) returns the JAX package's ``_greedy_decode`` tokens; back-to-back
eager requests on one template cache each get the tokens they get alone
(the serve step updates the recurrent state in place, and each eager
request decodes on a copy of the template); the serving weights hold the leaves the reference reads as
float32 in float32; a training state of the mamba2 tree crosses between
the two packages' ``CheckpointManager`` in both directions; and the
training launcher trains zamba2 and resumes it (the serving launcher's
hybrid case is in ``test_torch_serve.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jax_config
from repro.models import mamba2 as jm
from repro.optim import AdamW as JAdamW
from repro.serving.server import _greedy_decode as jax_greedy_decode
from repro.sharding import rules_for
from repro.train.steps import make_serve_step as jax_serve_step
from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
from repro_torch.configs import get_config
from repro_torch.core.genesys import Genesys, GenesysConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba2 as tm
from repro_torch.optim import OptState
from repro_torch.serving.server import (
    CpuBaselineUdpServer, GenesysUdpServer, _greedy_decode,
)
from repro_torch.train.steps import make_serve_step
from repro_torch.weights import from_jax_params, to_numpy_tree
from test_torch_dense_serve import _serve_requests

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
F32 = dict(params_dtype="float32", compute_dtype="float32",
           kv_cache_dtype="float32")
MAX_LEN = 32


@pytest.fixture()
def tgsys():
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    yield g
    g.shutdown()


@pytest.fixture(scope="module")
def model():
    """Reduced zamba2 in float32: the JAX package's parameters and the
    port's serving weights bridged from them."""
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **F32)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **F32)
    params, _ = jm.init(jax.random.PRNGKey(5), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    return jcfg, cfg, params, tparams


def _jax_tokens(model, mesh11, prompts, budgets):
    jcfg, _, params, _ = model
    serve = jax.jit(jax_serve_step(jcfg, rules_for(jcfg, mesh11)))
    cache = jm.init_cache(jcfg, 1, MAX_LEN)
    cl = jnp.zeros((1,), jnp.int32)
    with mesh11:
        return [jax_greedy_decode(serve, params, cache, cl,
                                  np.asarray(p, np.int32), n)
                for p, n in zip(prompts, budgets)]


def test_hybrid_udp_serving_matches_jax_greedy_decode(model, mesh11, tgsys):
    """Eager (tenants), bucketed (per-request budgets) and the CPU
    baseline answer every request with the JAX package's tokens."""
    _, cfg, _, tparams = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(1, 6, size=4)]
    budgets = [3, 6, 1, 5]
    want_eager = _jax_tokens(model, mesh11, prompts, [4] * len(prompts))
    want_budget = _jax_tokens(model, mesh11, prompts, budgets)
    serve = make_serve_step(cfg)
    cache = tm.init_cache(cfg, 1, MAX_LEN, device="cpu")
    port_of = lambda srv: tgsys.table._sockets[srv.fd].getsockname()[1]

    srv = GenesysUdpServer(tgsys, port=0, max_batch=4, payload=256,
                           batch_window_s=0.05, use_tenants=True)
    eager = _serve_requests(
        port_of(srv),
        lambda rp: srv.serve_model(serve, tparams, cache, n_batches=50,
                                   n_requests=4, reply_port=rp,
                                   max_tokens=4),
        prompts, n_replies=4)
    srv.close()
    assert sorted(eager) == sorted(want_eager)

    srv = GenesysUdpServer(tgsys, port=0, max_batch=4, payload=256,
                           batch_window_s=0.2, use_ring=True)
    tagged = [[b, 200 + i] + p
              for i, (b, p) in enumerate(zip(budgets, prompts))]
    bucketed = _serve_requests(
        port_of(srv),
        lambda rp: srv.serve_model(serve, tparams, cache, n_batches=50,
                                   n_requests=4, reply_port=rp,
                                   max_tokens=8, batch_decode=True,
                                   per_request_tokens=True),
        tagged, n_replies=4)
    srv.close()
    assert {r[0]: r[1:] for r in bucketed} == {
        200 + i: w for i, w in enumerate(want_budget)}

    cpu = CpuBaselineUdpServer(port=0)
    baseline = _serve_requests(
        cpu.sock.getsockname()[1],
        lambda rp: cpu.serve_model(serve, tparams, cache, n_batches=4,
                                   reply_port=rp, max_tokens=4),
        prompts, n_replies=4)
    cpu.close()
    assert sorted(baseline) == sorted(want_eager)


def test_back_to_back_requests_get_the_tokens_they_get_alone(model):
    """Every decode step reads the whole recurrent state, which the serve
    step writes in place: each eager request decodes on a copy of the one
    template cache, so served after another on the same cache it gets
    what it gets from a fresh cache, and the template keeps its zero
    state."""
    _, cfg, _, tparams = model
    serve = make_serve_step(cfg)
    cl = torch.zeros((1,), dtype=torch.int32)
    reqs = [(np.asarray([7, 300, 41], np.int32), 9),
            (np.asarray([12], np.int32), 4),
            (np.asarray([12], np.int32), 4)]
    alone = [_greedy_decode(serve, tparams,
                            tm.init_cache(cfg, 1, MAX_LEN, device="cpu"),
                            cl, p, n) for p, n in reqs]
    shared = tm.init_cache(cfg, 1, MAX_LEN, device="cpu")
    got = [_greedy_decode(serve, tparams, shared, cl, p, n) for p, n in reqs]
    assert got == alone
    assert all(t.abs().sum() == 0 for t in (shared["ssm"], shared["conv"]))


def test_serving_weights_hold_the_float32_leaves_in_float32():
    """The mamba blocks' ln and gated norm (rmsnorm scales), A_log and
    dt_bias, and the shared block's norms, stay in params_dtype in serving
    weights, from init and through the bridge; matrices and D are in the
    compute dtype."""
    cfg = get_config(ARCH).reduced()
    jparams, _ = jm.init(jax.random.PRNGKey(0), jax_config(ARCH).reduced())
    for params in (tm.init(cfg, seed=0, device="cpu"),
                   from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   cfg, device="cpu")):
        m = params["blocks"]["mamba"]
        for leaf in (params["blocks"]["ln"], m["norm"], m["A_log"],
                     m["dt_bias"], params["shared"]["ln_attn"],
                     params["shared"]["ln_mlp"], params["final_norm"]):
            assert leaf.dtype == torch.float32
        for leaf in (m["in_proj"], m["conv_w"], m["out_proj"], m["D"],
                     params["shared"]["attn"]["wq"],
                     params["shared"]["mlp"]["wo"], params["embed"],
                     params["lm_head"]):
            assert leaf.dtype == torch.bfloat16
    master = tm.init(cfg, seed=0, device="cpu", master=True)
    assert all(t.dtype == torch.float32 for t in flatten(master))


def _train_state(seed):
    """zamba2's reduced parameters and an AdamW state in both packages,
    the same values."""
    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams, _ = jm.init(jax.random.PRNGKey(seed), jcfg)
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


def test_jax_checkpoint_of_the_mamba2_tree_restores_into_the_port(
        gsys, tgsys, tmp_path):
    jtree, ttree = _train_state(0)
    JCheckpointManager(gsys, str(tmp_path)).save(2, jtree)
    got = CheckpointManager(tgsys, str(tmp_path)).restore(2, _zeros(ttree))
    g, w = flatten(got), flatten(ttree)
    assert len(g) == len(w) == len(jax.tree_util.tree_leaves(jtree))
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_of_the_mamba2_tree_restores_into_jax(
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
        np.asarray(got["params"]["blocks"]["mamba"]["A_log"]),
        to_numpy_tree(ttree["params"])["blocks"]["mamba"]["A_log"])


def test_launcher_trains_zamba2_then_resumes(tmp_path, capsys):
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "64", "--ckpt-dir",
            str(tmp_path / "ckpt"), "--ckpt-every", "3"]
    st = launch_train.main(args)
    assert st.steps == 3 and st.ckpts == 1
    assert all(np.isfinite(l) for l in st.losses)
    st = launch_train.main(args + ["--resume", "--steps", "2"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert st.steps == 2 and all(np.isfinite(l) for l in st.losses)

"""The port's checkpointing and training loop on its own GENESYS host
plane: the checkpoint tests of ``test_substrates.py`` (roundtrip with a
bf16 leaf, gc and latest, crash consistency), leaves larger than one
pwrite/pread call, checkpoints crossing between the JAX package's
``CheckpointManager`` and the port's in both directions (a training state
with its optimizer state included), ``test_system.py``'s end-to-end
training with loader, async checkpoints and resume, and the launcher
``python -m repro_torch.launch.train`` run in-process, then resumed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jax_config
from repro.models.registry import get_api
from repro.optim import AdamW as JAdamW
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.genesys import Genesys, GenesysConfig
from repro_torch.data.pipeline import GenesysDataLoader, write_token_shard
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.optim import AdamW, OptState
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import make_train_step
from repro_torch.weights import from_jax_params, to_numpy_tree

torch.set_num_threads(1)


@pytest.fixture()
def tgsys():
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    yield g
    g.shutdown()


def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"x": torch.full((5,), 1.5, dtype=torch.bfloat16),
                  "n": torch.tensor(7, dtype=torch.int32)}}


def _zeros(tree):
    """A tree of zeros with ``tree``'s structure, shapes and dtypes."""
    if isinstance(tree, OptState):
        return OptState(_zeros(tree.m), _zeros(tree.v),
                        torch.zeros_like(tree.count))
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _assert_trees_equal(got, want):
    g, w = flatten(got), flatten(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_roundtrip(tgsys, tmp_path):
    cm = CheckpointManager(tgsys, str(tmp_path), keep=2)
    t = _tree()
    manifest = cm.save(10, t)
    # jax.tree_util order: keys sorted at every level
    assert [m["dtype"] for m in manifest["leaves"]] == ["int32", "bfloat16",
                                                        "float32"]
    _assert_trees_equal(cm.restore(10, _zeros(t)), t)


def test_checkpoint_restores_in_place(tgsys, tmp_path):
    cm = CheckpointManager(tgsys, str(tmp_path))
    t = _tree()
    cm.save(1, t)
    live = _zeros(t)
    targets = flatten(live)
    out = cm.restore(1, live)
    assert all(a is b for a, b in zip(flatten(out), targets))
    _assert_trees_equal(live, t)


@pytest.mark.parametrize("leaf", [torch.zeros(3, 4, dtype=torch.bfloat16),
                                  torch.zeros(4, 3)])
def test_checkpoint_restore_rejects_a_leaf_that_does_not_fit(tgsys, tmp_path,
                                                             leaf):
    cm = CheckpointManager(tgsys, str(tmp_path))
    cm.save(1, _tree())
    like = _zeros(_tree())
    like["w"] = leaf
    with pytest.raises(ValueError, match="does not fit"):
        cm.restore(1, like)


def test_checkpoint_gc_and_latest(tgsys, tmp_path):
    cm = CheckpointManager(tgsys, str(tmp_path), keep=2)
    for s in (1, 2, 3):
        cm.save(s, _tree())
    assert cm.list_steps() == [2, 3]
    assert cm.latest_step() == 3


def test_checkpoint_crash_consistency(tgsys, tmp_path):
    """A step dir without a committed manifest is invisible."""
    cm = CheckpointManager(tgsys, str(tmp_path), keep=3)
    cm.save(5, _tree())
    broken = tmp_path / "step_00000009"
    broken.mkdir()
    (broken / "leaf_00000.bin").write_bytes(b"partial garbage")
    assert cm.list_steps() == [5]
    assert cm.latest_step() == 5


def test_leaves_larger_than_one_io_call_travel_in_pieces(tgsys, tmp_path,
                                                         monkeypatch):
    """Linux moves at most 2 GiB - 4 KiB per pwrite/pread; a leaf goes out
    in IO_CHUNK pieces at their offsets (here 64-byte pieces, so the
    odd-sized leaf ends in a short one)."""
    monkeypatch.setattr(tckpt, "IO_CHUNK", 64)
    t = {"big": torch.randn(1000, generator=torch.Generator().manual_seed(0)),
         "odd": torch.arange(37, dtype=torch.int32)}
    cm = CheckpointManager(tgsys, str(tmp_path))
    cm.save(1, t)
    assert (tmp_path / "step_00000001" / "leaf_00000.bin").stat().st_size \
        == 4000
    assert tgsys.table.stats["PWRITE64"] == 63 + 3
    _assert_trees_equal(cm.restore(1, _zeros(t)), t)


def _train_state(seed=0):
    """A reduced model's parameters and AdamW state in both packages, the
    same values: JAX's init bridged into the port (float32 master weights)
    and one optimizer step's worth of moments."""
    jcfg = jax_config("qwen2-72b").reduced()
    cfg = get_config("qwen2-72b").reduced()
    jparams, _ = get_api(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    jstate = JAdamW().init(jparams)
    rng = np.random.default_rng(seed)
    jstate = dataclasses.replace(
        jstate,
        m=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape, dtype=np.float32)), jparams),
        v=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.random(p.shape, dtype=np.float32)), jparams),
        count=jnp.asarray(7, jnp.int32))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", master=True)
    tstate = OptState(
        m=from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.m), cfg,
                          device="cpu", master=True),
        v=from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.v), cfg,
                          device="cpu", master=True),
        count=torch.tensor(7, dtype=torch.int32))
    return ({"params": jparams, "opt": jstate},
            {"params": tparams, "opt": tstate})


def test_jax_checkpoint_restores_into_the_port(gsys, tgsys, tmp_path):
    """The JAX package's CheckpointManager writes a training state (params
    and OptState, plus a bf16 leaf); the port restores it into its own
    structure, leaf for leaf, to equal values."""
    jtree, ttree = _train_state()
    jtree["extra"] = jnp.asarray([1.5, -2.25], jnp.bfloat16)
    ttree["extra"] = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    JCheckpointManager(gsys, str(tmp_path)).save(3, jtree)
    got = CheckpointManager(tgsys, str(tmp_path)).restore(
        3, _zeros(ttree))
    _assert_trees_equal(got, ttree)


def test_port_checkpoint_restores_into_jax(gsys, tgsys, tmp_path):
    jtree, ttree = _train_state(seed=1)
    ttree["extra"] = torch.tensor([0.5, 3.0], dtype=torch.bfloat16)
    jtree["extra"] = jnp.asarray([0.5, 3.0], jnp.bfloat16)
    CheckpointManager(tgsys, str(tmp_path)).save(4, ttree)
    like = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    got = JCheckpointManager(gsys, str(tmp_path)).restore(4, like)
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jtree)
    assert len(gl) == len(wl) == len(flatten(ttree))
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(got["params"]["embed"]),
        to_numpy_tree(ttree["params"])["embed"])


def test_end_to_end_training_with_genesys_services(tgsys, tmp_path):
    """test_system.py's: loader (pread prefetch) -> 32 train steps ->
    async checkpoints -> crash -> resume at step 32 -> losses finite and
    falling."""
    shard = str(tmp_path / "tok.bin")
    write_token_shard(shard, np.random.default_rng(0).integers(
        0, 500, size=300_000).astype(np.uint32))
    cfg = get_config("internlm2-20b").reduced()
    params = transformer.init(cfg, seed=0, device="cpu", master=True)
    ts, opt = make_train_step(cfg, TrainConfig(lr=3e-3))
    loader = GenesysDataLoader(tgsys, [shard], batch=4, seq=32)
    cm = CheckpointManager(tgsys, str(tmp_path / "ckpt"), keep=2)
    tr = Trainer(tgsys, ts, params, opt.init(params), loader, ckpt=cm,
                 ckpt_every=16)
    st = tr.run(32)
    assert st.steps == 32 and st.ckpts == 2
    assert all(np.isfinite(l) for l in st.losses)
    assert np.mean(st.losses[-3:]) < np.mean(st.losses[:3])
    saved = [x.detach().clone() for x in flatten(
        {"params": tr.params, "opt": tr.opt_state})]

    # simulated crash: a fresh trainer over other weights resumes
    params2 = transformer.init(cfg, seed=1, device="cpu", master=True)
    tr2 = Trainer(tgsys, ts, params2, opt.init(params2), loader, ckpt=cm)
    assert tr2.resume()
    assert tr2.step == 32
    for a, b in zip(flatten({"params": tr2.params, "opt": tr2.opt_state}),
                    saved):
        assert torch.equal(a, b)
    st2 = tr2.run(2)
    assert all(np.isfinite(l) for l in st2.losses)
    loader.close()


def test_launcher_trains_then_resumes(tmp_path, capsys):
    args = ["--arch", "starcoder2-7b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path / "ckpt"), "--ckpt-every", "3"]
    st = launch_train.main(args)
    assert st.steps == 3 and st.ckpts == 1
    assert all(np.isfinite(l) for l in st.losses)
    st = launch_train.main(args + ["--resume", "--steps", "2"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert st.steps == 2 and all(np.isfinite(l) for l in st.losses)

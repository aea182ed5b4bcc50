"""The port's planning tools against the JAX package's: ``input_specs``
and ``model_flops`` for every arch and shape, ``perf.op_cost``'s counting
conventions (the 7-layer scan of ``test_system.py``, a sharded product
per device), the production meshes, the hillclimb's variants, and one
dry-run cell (seamless-m4t-medium, decode_32k, 512 ranks) whose per-device
argument bytes must be the sum of the reference's shard bytes. The cells
and meshes run in subprocesses, as the reference's do."""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.config import shapes_for as jax_shapes_for
from repro.configs import get_config as jax_config
from repro.launch.specs import input_specs as jax_input_specs
from repro.perf.roofline import model_flops as jax_model_flops
from repro_torch.config import shapes_for
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.launch.specs import input_specs
from repro_torch.perf import roofline
from repro_torch.perf.op_cost import OpCost

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s.name) for a in all_arch_ids()
         for s in shapes_for(get_config(a))]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{path}/{k}")]
    return [(path, tree)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    sh = next(s for s in shapes_for(cfg) if s.name == shape)
    jsh = next(s for s in jax_shapes_for(jcfg) if s.name == shape)
    for kv_rep in (1, 2):
        ours = _flat(input_specs(cfg, sh, kv_rep=kv_rep))
        ref = _flat(jax_input_specs(jcfg, jsh, kv_rep=kv_rep))
        assert [p for p, _ in ours] == [p for p, _ in ref]
        for (path, t), (_, s) in zip(ours, ref):
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(s.shape), path
            assert str(t.dtype).removeprefix("torch.") == s.dtype.name, path


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    sh = next(s for s in shapes_for(get_config(arch)) if s.name == shape)
    jsh = next(s for s in jax_shapes_for(jax_config(arch))
               if s.name == shape)
    assert roofline.model_flops(get_config(arch), sh) == \
        jax_model_flops(jax_config(arch), jsh)


def test_op_cost_counts_the_7_layer_scan():
    """``test_system.py``'s scan of tanh(c @ w) over 7 layers, forward and
    backward: a forward product, dx and dw each 7 times. Eager runs every
    trip, so no loop is left uncounted."""
    ws = torch.randn(7, 64, 64, requires_grad=True)
    x = torch.randn(8, 64, requires_grad=True)
    with OpCost() as c:
        h = x
        for w in ws.unbind(0):
            h = torch.tanh(h @ w)
        h.sum().backward()
    assert c.flops == 2 * 8 * 64 * 64 * 7 * 3
    assert c.bytes > 0 and c.collectives.wire_bytes == 0


def test_op_cost_byte_conventions():
    """Views and dtype-only converts are free; an op reads its unique
    operands once and writes its result; an in-place scatter of rows
    reads and writes the rows, not the buffer."""
    a = torch.randn(64, 64)
    buf = torch.zeros(1000, 64)
    with OpCost() as c:
        a.view(-1)
        a.t()
        a.to(torch.bfloat16)
    assert c.bytes == 0
    with OpCost() as c:
        a + a
    assert c.bytes == 2 * a.numel() * 4
    idx, rows = torch.tensor([3, 5]), torch.ones(2, 64)
    with OpCost() as c:
        buf.index_copy_(0, idx, rows)
    assert c.bytes == 2 * (2 * 8 + 2 * 64 * 4)


def test_ring_model_and_h100_constants():
    assert roofline.ring_wire_bytes("all-reduce", 100.0, 4) == 150.0
    assert roofline.ring_wire_bytes("all-gather", 100.0, 4) == 75.0
    assert roofline.ring_wire_bytes("reduce-scatter", 100.0, 4) == 300.0
    assert roofline.ring_wire_bytes("collective-permute", 100.0, 4) == 100.0
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    rl = roofline.roofline_terms(989e12, 3.35e12, 500e9, 1.0, 1,
                                 cross_node_wire_bytes_dev=50e9)
    assert rl.compute_s == 1.0 and rl.memory_s == 1.0
    assert rl.collective_s == pytest.approx(450e9 / 450e9 + 50e9 / 50e9)
    assert rl.bottleneck == "collective"


@pytest.fixture(scope="module")
def mesh16():
    """A 16-way "model" mesh over a fake world, torn down after."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import mesh as tmesh
    tmesh.fake_world(16)
    yield init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
    tmesh.release_world()


@pytest.mark.parametrize("sharded", [True, False],
                         ids=["16way", "replicated"])
def test_op_cost_counts_each_device_its_share(mesh16, sharded):
    """The dispatch mode sees the ops each device runs on its shards: a
    product over a weight split 16 ways on its columns counts 1/16 of its
    global flops, a replicated one its whole count, on every device."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        x_local = torch.empty(64, 4096)
        w_local = torch.empty(4096, 4096 // 16 if sharded else 4096)
    x = DTensor.from_local(x_local, mesh16, [Replicate()], run_check=False)
    w = DTensor.from_local(w_local, mesh16,
                           [Shard(1) if sharded else Replicate()],
                           run_check=False)
    c = OpCost(counts=lambda t: isinstance(t, FakeTensor)
               and t.fake_mode is fake)
    with c:
        x @ w
    full = 2.0 * 64 * 4096 * 4096
    assert c.flops == (full / 16 if sharded else full)


@pytest.mark.parametrize("pin", [True, False], ids=["pinned", "reshaped"])
def test_merged_heads_take_their_gradient_back_whole(mesh16, pin):
    """40 heads of 64 merged into D = 2560 on a 16-way mesh, then a
    product with a weight split 16 ways on D: the gradient comes back
    sharded on D into 160-wide parts, 2.5 heads, which the reshape's
    backward cannot split into heads; ``layers.pinned`` takes it back in
    the merge's own (replicated) placement first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import layers as L
    o = DTensor.from_local(torch.randn(2, 8, 40, 64, requires_grad=True),
                           mesh16, [Replicate()], run_check=False)
    m = o.reshape(2, 8, 2560)
    if pin:
        m = L.pinned(m)
    w = DTensor.from_local(torch.randn(2560 // 16), mesh16, [Shard(0)],
                           run_check=False)
    y = m * w
    assert y.placements == (Shard(2),)
    if pin:
        y.sum().backward()
    else:
        with pytest.raises(RuntimeError, match="unevenly sharded"):
            y.sum().backward()


def test_production_mesh_shapes():
    code = textwrap.dedent("""
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.sharding import mesh_sizes
        m2 = make_production_mesh(multi_pod=True)
        m1 = make_production_mesh()
        assert mesh_sizes(m1) == {'data': 16, 'model': 16}
        assert mesh_sizes(m2) == {'pod': 2, 'data': 16, 'model': 16}
        print('MESH_OK')
    """)
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert "MESH_OK" in r.stdout, r.stdout + r.stderr[-3000:]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hillclimb_variants_equal_the_reference():
    ours = _load(ROOT / "experiments" / "torch_hillclimb.py",
                 "torch_hillclimb")
    ref = _load(ROOT / "experiments" / "hillclimb.py", "hillclimb")
    assert ours.VARIANTS == ref.VARIANTS
    assert ours.OUT.name == "torch_hillclimb.json"


REFERENCE_ARGUMENT_BYTES = textwrap.dedent("""
    import math
    import jax, jax.numpy as jnp
    from repro.launch.dryrun import (
        _cast_tree_shapes, batch_sharding_tree, shapes_and_axes)
    from repro.config import SHAPES
    from repro.configs import get_config
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import input_specs
    from repro.models.registry import get_api
    from repro.sharding import rules_for, tree_shardings

    cfg, shape = get_config('seamless-m4t-medium'), SHAPES['decode_32k']
    mesh = make_production_mesh(multi_pod=True)
    rules = rules_for(cfg, mesh, fsdp=True)
    shapes, axes = shapes_and_axes(get_api(cfg).init,
                                   jax.random.PRNGKey(0), cfg)
    shapes = _cast_tree_shapes(shapes, jnp.bfloat16)
    shard = tree_shardings(mesh, rules, axes, shapes,
                           fsdp_axes=('pod', 'data'))
    specs = input_specs(cfg, shape, kv_rep=rules.kv_rep)
    bshard = batch_sharding_tree(cfg, mesh, rules, specs)
    total = 0
    for sh_tree, s_tree in ((shard, shapes), (bshard, specs)):
        sh = jax.tree_util.tree_leaves(
            sh_tree, is_leaf=lambda x: hasattr(x, 'shard_shape'))
        for n, s in zip(sh, jax.tree_util.tree_leaves(s_tree)):
            total += math.prod(n.shard_shape(s.shape)) * s.dtype.itemsize
    print('REF_BYTES', total)
""")


def test_dryrun_cell_in_subprocess():
    """The reference's cell, on the port: 512 fake ranks, H100 roofline
    terms, and each device's arguments exactly its shards of the
    reference's plan."""
    code = textwrap.dedent("""
        import json
        from repro_torch.launch.dryrun import run_cell
        out = run_cell('seamless-m4t-medium', 'decode_32k', True)
        print('CELL ' + json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("CELL ")]
    assert line, r.stdout[-2000:] + r.stderr[-4000:]
    out = json.loads(line[0][len("CELL "):])
    assert out["status"] == "ok", out
    assert out["chips"] == 512 and out["mesh"] == "2x16x16"
    rl = out["roofline"]
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["compute_s"] == rl["flops_dev"] / 989e12
    assert rl["memory_s"] == rl["hbm_bytes_dev"] / 3.35e12
    assert out["cost"]["flops_dev"] > 0 and out["collectives"]["by_op"]
    mem = out["memory"]
    assert mem["peak_bytes_dev"] == (mem["argument_bytes_dev"]
                                     + mem["output_bytes_dev"]
                                     + mem["temp_bytes_dev"]
                                     - mem["alias_bytes_dev"])
    r = subprocess.run([sys.executable, "-c", REFERENCE_ARGUMENT_BYTES],
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    ref = [ln for ln in r.stdout.splitlines() if ln.startswith("REF_BYTES")]
    assert ref, r.stdout[-2000:] + r.stderr[-4000:]
    assert mem["argument_bytes_dev"] == int(ref[0].split()[1])


RWKV6_CELL = textwrap.dedent("""
    import json
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, mesh

    def small_mesh(multi_pod=False):
        mesh.fake_world(16)
        return init_device_mesh('cpu', (2, 8),
                                mesh_dim_names=('data', 'model'))
    dryrun.make_production_mesh = small_mesh
    r = get_config('rwkv6-3b').reduced()
    cut = {f: getattr(r, f) for f in ('n_layers', 'd_model', 'n_heads',
           'n_kv_heads', 'head_dim', 'd_ff', 'vocab_size')}
    out = dryrun.run_cell('rwkv6-3b', 'train_4k', False, microbatches=1,
                          cfg_overrides=cut)
    print('CELL ' + json.dumps(out))
""")


def test_rwkv6_train_cell_splits_heads_its_shards_cut():
    """rwkv6-3b's train_4k cell at the reduced widths on a (2, 8) fake
    mesh: "model" cuts D = 128 into shards of 16, half a head of 32, so
    the time mix's fused projections cannot be split into heads (nor
    their heads merged back) as they lie; the cell runs to its end with
    the heads gathered first, and every device counts its share."""
    r = subprocess.run([sys.executable, "-c", RWKV6_CELL], env=_env(),
                       capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("CELL ")]
    assert line, r.stdout[-2000:] + r.stderr[-4000:]
    out = json.loads(line[0][len("CELL "):])
    assert out["status"] == "ok", out
    assert out["chips"] == 16
    assert out["cost"]["flops_dev"] > 0
    assert out["memory"]["peak_bytes_dev"] > 0
    assert out["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")

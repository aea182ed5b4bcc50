"""The port's sharding plumbing against the JAX package's: the logical
axes of every parameter and cache leaf, the sharding rules of every arch
on both production meshes, the local shard shapes of starcoder2-7b's and
qwen2-72b's parameters on the 16 x 16 mesh, and the order in which a dim
split over several mesh dims is cut. The JAX side of the mesh checks runs
in a subprocess with 512 host devices (nothing is compiled); the port's
runs on a fake world of 256 or 512 ranks in this process."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from repro.configs import all_arch_ids as jax_arch_ids
from repro.configs import get_config as jax_config
from repro.models.registry import get_api as jax_api
from repro_torch import sharding
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models.registry import get_api

ROOT = Path(__file__).resolve().parents[1]


def _jax_shapes_and_axes(cfg):
    """The reference dry run's ``shapes_and_axes``: eval_shape of the init,
    its axes tree captured while tracing."""
    box = {}

    def wrapper(r):
        params, axes = jax_api(cfg).init(r, cfg)
        box["axes"] = axes
        return params
    shapes = jax.eval_shape(wrapper, jax.random.PRNGKey(0))
    return shapes, box["axes"]


def _pairs(port, ref, path=""):
    """(path, port leaf, reference leaf) over two nested dicts with the
    same keys."""
    assert isinstance(port, dict) and isinstance(ref, dict), path
    assert sorted(port) == sorted(ref), path
    out = []
    for k in port:
        if isinstance(port[k], dict):
            out += _pairs(port[k], ref[k], f"{path}/{k}")
        else:
            out.append((f"{path}/{k}", port[k], ref[k]))
    return out


def _jsonable(v):
    return list(v) if isinstance(v, tuple) else v


def test_arch_lists_agree():
    assert all_arch_ids() == jax_arch_ids()


@pytest.mark.parametrize("arch", all_arch_ids())
def test_param_axes_and_shapes_equal_the_reference(arch):
    """At full size: the port's tree built on ``meta`` against the
    reference's ``eval_shape``, leaf by leaf: shape and logical axes."""
    cfg = get_config(arch)
    api = get_api(cfg)
    shapes, axes = _jax_shapes_and_axes(jax_config(arch))
    meta = api.init(cfg, device="meta", master=True)
    port_axes = api.param_axes(cfg)
    leaves = _pairs(meta, shapes)
    assert leaves
    for path, t, s in leaves:
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape), path
        assert jnp.dtype(str(t.dtype).split(".")[1]) == s.dtype, path
    for path, a, b in _pairs(port_axes, axes):
        assert a == tuple(b), path


@pytest.mark.parametrize("arch", all_arch_ids())
def test_cache_axes_equal_the_reference(arch):
    cfg = get_config(arch)
    port = get_api(cfg).cache_axes(cfg)
    ref = jax_api(jax_config(arch)).cache_axes(jax_config(arch))
    for path, a, b in _pairs(port, ref):
        assert a == tuple(b), path


def test_kv_repeat_rules():
    assert sharding.kv_repeat(get_config("qwen2-72b"), 16) == 2
    assert sharding.kv_repeat(get_config("internlm2-20b"), 16) == 2
    assert sharding.kv_repeat(get_config("starcoder2-7b"), 16) == 1
    assert sharding.kv_repeat(get_config("llava-next-34b"), 16) == 1
    assert sharding.kv_repeat(get_config("zamba2-2.7b"), 16) == 1


# ------------------------------------------------ meshes over fake worlds --

JAX_SIDE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import all_arch_ids, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.models.registry import get_api
    from repro.sharding import rules_for, tree_shardings

    def js(v):
        return list(v) if isinstance(v, tuple) else v

    out = {"rules": {}, "shards": {}}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in all_arch_ids():
            r = rules_for(get_config(arch), mesh)
            out["rules"][f"{arch}|{multi}"] = {
                "kv_rep": r.kv_rep,
                "rules": {k: js(v) for k, v in r.rules.items()}}
    mesh = make_production_mesh()
    for arch in ("starcoder2-7b", "qwen2-72b"):
        cfg = get_config(arch)
        box = {}
        def wrapper(key):
            params, axes = get_api(cfg).init(key, cfg)
            box["axes"] = axes
            return params
        shapes = jax.eval_shape(wrapper, jax.random.PRNGKey(0))
        for fsdp in (None, ("data",)):
            sh = tree_shardings(mesh, rules_for(cfg, mesh, fsdp=bool(fsdp)),
                                box["axes"], shapes, fsdp_axes=fsdp)
            flat = jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(lambda s, x: s.shard_shape(x.shape),
                                       sh, shapes,
                                       is_leaf=lambda x: isinstance(
                                           x, NamedSharding)),
                is_leaf=lambda x: isinstance(x, tuple))
            out["shards"][f"{arch}|{bool(fsdp)}"] = {
                jax.tree_util.keystr(p): list(v) for p, v in flat}
    # a (2, 2, 2) mesh: each device's slice of a [8, 4] array
    m8 = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
              ("pod", "data", "model"))
    idx = {}
    for name, spec in (("pod_data", P(("pod", "data"), "model")),
                       ("data_model", P(None, ("data", "model"))),
                       ("all", P(("pod", "data", "model"), None))):
        dmap = NamedSharding(m8, spec).devices_indices_map((8, 4))
        idx[name] = {str(d.id): [[s.start or 0, s.stop or n]
                                 for s, n in zip(sl, (8, 4))]
                     for d, sl in dmap.items()}
    out["indices"] = idx
    print("JAX_SIDE " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE], env=env,
                       capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JAX_SIDE ")]
    assert line, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(line[0][len("JAX_SIDE "):])


@pytest.fixture(scope="module")
def meshes():
    """The port's production meshes over fake worlds (the single-pod one
    last, so its world is the one left standing), torn down after."""
    multi = tmesh.make_production_mesh(multi_pod=True)
    single = tmesh.make_production_mesh()
    yield {False: single, True: multi}
    tmesh.release_world()


def test_production_meshes_have_the_reference_shapes(meshes):
    assert sharding.mesh_sizes(meshes[False]) == {"data": 16, "model": 16}
    assert sharding.mesh_sizes(meshes[True]) == {"pod": 2, "data": 16,
                                                 "model": 16}
    assert meshes[False].size() == 256 and meshes[True].size() == 512


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", all_arch_ids())
def test_rules_for_equal_the_reference(reference, meshes, arch, multi):
    r = sharding.rules_for(get_config(arch), meshes[multi])
    ref = reference["rules"][f"{arch}|{multi}"]
    assert r.kv_rep == ref["kv_rep"]
    assert {k: _jsonable(v) for k, v in r.rules.items()} == ref["rules"]


@pytest.mark.parametrize("fsdp", [False, True], ids=["nofsdp", "fsdp"])
@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-72b"])
def test_shard_shapes_on_16x16_equal_the_reference(reference, meshes, arch,
                                                   fsdp):
    """Every parameter's local shard: the port's NamedSharding, and
    DTensor's own local shape for the placements it maps to, against
    JAX's ``NamedSharding.shard_shape``."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
    )
    mesh = meshes[False]
    cfg = get_config(arch)
    api = get_api(cfg)
    shapes = api.init(cfg, device="meta", master=True)
    rules = sharding.rules_for(cfg, mesh, fsdp=fsdp)
    sh = sharding.tree_shardings(mesh, rules, api.param_axes(cfg), shapes,
                                 fsdp_axes=("data",) if fsdp else None)
    ref = reference["shards"][f"{arch}|{fsdp}"]
    got = {}
    for path, s, t in _pairs(sh, shapes):
        local = s.shard_shape(tuple(t.shape))
        dt_local, _ = _compute_local_shape_and_global_offset(
            tuple(t.shape), tuple(mesh.shape), [0, 0], s.placements)
        assert tuple(dt_local) == local, path
        key = "".join(f"['{k}']" for k in path.strip("/").split("/"))
        got[key] = list(local)
    assert got == ref


@pytest.mark.parametrize("name,spec", [
    ("pod_data", (("pod", "data"), "model")),
    ("data_model", (None, ("data", "model"))),
    ("all", (("pod", "data", "model"), None))])
def test_multi_axis_dims_are_cut_in_jax_order(reference, name, spec):
    """A dim over several mesh dims: DTensor's slice for each device of a
    (2, 2, 2) mesh is JAX's (``devices_indices_map``), device i at
    coordinate (i // 4, i // 2 % 2, i % 2) in both."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
    )
    import torch
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"),
                      _init_backend=False)
    pl = sharding.placements(spec, mesh)
    want = reference["indices"][name]
    for dev in range(8):
        coord = [dev // 4, dev // 2 % 2, dev % 2]
        shape, off = _compute_local_shape_and_global_offset(
            (8, 4), (2, 2, 2), coord, pl)
        got = [[o, o + n] for o, n in zip(off, shape)]
        assert got == want[str(dev)], (dev, pl)


def test_spec_out_of_mesh_order_is_refused(meshes):
    with pytest.raises(ValueError, match="order"):
        sharding.placements((("data", "pod"),), meshes[True])


def test_fit_spec_drops_nondivisible(meshes):
    mesh = meshes[False]
    assert sharding.fit_spec(("model", None), (7, 3), mesh) == (None, None)
    assert sharding.fit_spec(("model", None), (32, 3), mesh) == ("model",
                                                                 None)


def test_apply_fsdp_picks_largest_free_dim(meshes):
    """The reference's case, on the 16 x 16 mesh."""
    spec = sharding.apply_fsdp((None, "model", None),
                               ("embed", "heads", "head_dim"),
                               (4096, 32, 128), meshes[False], ("data",))
    assert spec == (("data",), "model", None)


def test_constrain_leaves_plain_tensors_and_no_mesh_alone():
    import torch
    x = torch.ones(2, 3)
    assert sharding.constrain(x, None, "batch", "embed") is x
    r = sharding.ShardingRules()
    assert sharding.constrain(x, r, "batch", "embed") is x

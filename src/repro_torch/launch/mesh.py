"""Mesh builders of the PyTorch port (the counterpart of
``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
data=16, model=16) = 512 devices; the "pod" dim composes with "data" for
cross-pod data parallelism.

FUNCTIONS, not module-level constants: importing this module touches no
process group. The production meshes exist to plan on (``launch.dryrun``):
:func:`make_production_mesh` builds one over a world of "fake" ranks (the
``fake`` backend of ``torch.distributed``, which moves no data), on the
``cpu`` device type, in any process and on a machine without a GPU.
Shapes, dtypes and the collectives DTensor inserts do not depend on the
device type. :func:`make_host_mesh` builds a mesh over the real process
group that the caller started.

The reference's ``mesh_axis_kwargs`` is a JAX-version shim (the
``axis_types=`` argument of ``jax.make_mesh``) and has no counterpart.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def fake_world(size: int) -> None:
    """Make this process rank 0 of a world of ``size`` fake ranks. A fake
    world of another size is torn down first; a real process group is
    left alone and refused."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group is running; the "
                f"production meshes plan on a fake world of their own")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    # importing the module registers the fake backend's constructor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def release_world() -> None:
    """Tear down the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) mesh, over a fake world of 256 or 512
    ranks (:func:`fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over the process group the caller started
    (``torch.distributed.init_process_group``): NCCL ranks on the cards,
    gloo ranks on the CPU. ``data * model`` must be its world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the world has {world}")
    backend = dist.get_backend()
    if backend not in ("nccl", "gloo"):
        raise RuntimeError(f"make_host_mesh takes an nccl or gloo process "
                           f"group, not {backend}")
    return init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            (data, model), mesh_dim_names=("data", "model"))

"""Multi-process jobs of the port's CPU tests on ``gloo`` (not a test
module: ``test_torch_sharded_step.py`` and ``test_torch_compression.py``
run it as a script, in a subprocess of their own).

    python tests/torch_dist_jobs.py sharded_step 2,2
    python tests/torch_dist_jobs.py compressed_reduce 2,4
    python tests/torch_dist_jobs.py launch_dp 2 CKPT_DIR [ARCH]
    python tests/torch_dist_jobs.py scan_shards 2,2

Each job spawns one process per rank of the mesh's shape, joins them in a
gloo group at ``tcp://localhost:<free port>``, and prints one line
``RESULT <json>`` with every rank's result (or ``ERROR`` and the
tracebacks). Exits 0 only if every rank finished. Arguments after the
shape go to the job.
"""
import contextlib
import dataclasses
import io
import os
import json
import math
import socket
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = str(Path(__file__).resolve().parents[1] / "src")


def sharded_step(mesh_shape):
    """Reduced starcoder2-7b in f32: one train step (loss, grad norm) and
    six greedy decode steps over a carried cache, once on plain tensors
    and once with parameters, inputs and cache as DTensors on the mesh
    placed by ``rules_for``."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import PLAIN, PLAIN_DECODE
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.sharding import rules_for, tree_shardings
    from repro_torch.train.steps import make_serve_step, make_train_step

    cfg = dataclasses.replace(get_config("starcoder2-7b").reduced(),
                              params_dtype="float32",
                              compute_dtype="float32",
                              kv_cache_dtype="float32")
    api = get_api(cfg)
    mesh = make_host_mesh(*mesh_shape)
    rules = rules_for(cfg, mesh)

    def place(tree, axes):
        sh = tree_shardings(mesh, rules, axes, tree)
        return _map2(lambda t, s: distribute_tensor(t, mesh, s.placements),
                     tree, sh)

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 17)))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    out = {"kv_rep": rules.kv_rep}
    for sharded in (False, True):
        params = api.init(cfg, seed=0, device="cpu", master=True)
        ts, opt = make_train_step(cfg, TrainConfig(), PLAIN,
                                  rules=rules if sharded else None)
        b = batch
        if sharded:
            params = place(params, api.param_axes(cfg))
            b = {k: place(v, ("batch", "seq")) for k, v in batch.items()}
        with implicit_replication():
            _, _, m = ts(params, opt.init(params), b)
        out[f"train_{sharded}"] = {k: float(_full(m[k]))
                                   for k in ("loss", "grad_norm")}

        params = api.init(cfg, seed=1, device="cpu")
        cache = api.init_cache(cfg, 4, 32, device="cpu",
                               kv_rep=rules.kv_rep if sharded else 1)
        sv = make_serve_step(cfg, PLAIN_DECODE,
                             rules=rules if sharded else None)
        if sharded:
            params = place(params, api.param_axes(cfg))
            cache = place(cache, api.cache_axes(cfg))
        cur = batch["tokens"][:, :1].clone()
        seq = []
        with implicit_replication():
            for t in range(6):
                cl = torch.full((4,), t, dtype=torch.int32)
                c = cur
                if sharded:
                    c, cl = place(cur, ("batch", None)), place(cl, ("batch",))
                nxt, cache = sv(params, cache, c, cl)
                seq.append(_full(nxt).tolist())
                cur = torch.tensor(seq[-1])[:, None]
        out[f"tokens_{sharded}"] = seq
    return out


def compressed_reduce(mesh_shape):
    """Each rank of the (pod, data) world holds one row of an [8, 64]
    gradient; the tree is summed over every rank (the reference's psum
    over ("pod", "data")) by ``all_reduce_tree`` in bf16 and in int8_ef,
    against the exact sum."""
    from repro_torch.optim.compression import all_reduce_tree

    assert dist.get_world_size() == math.prod(mesh_shape)
    g = torch.arange(8 * 64, dtype=torch.float32).reshape(8, 64) / 100
    mine = {"g": g[dist.get_rank()].clone()}
    ref = g.sum(0)
    out = {}
    for method in ("bf16", "int8_ef"):
        summed, _ = all_reduce_tree(mine, method)
        out[method] = float((summed["g"] - ref).abs().max())
    return out


# the data-parallel launcher's run: a reduced config (internlm2-20b unless
# named), 3 steps with a checkpoint at step 3, then a resumed run of 1 step
LAUNCH_ARGS = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
               "--lr", "1e-3"]
LAUNCH_ARCH = "internlm2-20b"
LAUNCH_STEPS = 3


@contextlib.contextmanager
def f32_configs():
    """``configs.get_config`` giving each config in float32 (parameters
    and compute), so that a data-parallel step can be held to the
    one-process step to 1e-5."""
    from repro_torch import configs
    get = configs.get_config
    configs.get_config = lambda arch: dataclasses.replace(
        get(arch), params_dtype="float32", compute_dtype="float32")
    try:
        yield
    finally:
        configs.get_config = get


def launch_train(ckpt_dir, arch=LAUNCH_ARCH, seq=None):
    """``launch.train.main`` of ``arch`` as LAUNCH_ARGS say, in f32:
    LAUNCH_STEPS steps checkpointed at the last into ``ckpt_dir``, then a
    run that resumes from it and takes one step (``seq``: in place of
    LAUNCH_ARGS's sequence length). Returns each run's losses and printed
    lines."""
    from repro_torch.launch import train

    out = {}
    with f32_configs():
        for name, extra in (
                ("first", ["--steps", str(LAUNCH_STEPS), "--ckpt-dir",
                           ckpt_dir, "--ckpt-every", str(LAUNCH_STEPS)]),
                ("resumed", ["--steps", "1", "--ckpt-dir", ckpt_dir,
                             "--resume"])):
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                st = train.main(["--arch", arch] + LAUNCH_ARGS + extra
                                + ([] if seq is None else ["--seq", seq]))
            out[name] = {"losses": st.losses, "ckpts": st.ckpts,
                         "printed": printed.getvalue()}
    return out


def launch_dp(mesh_shape, ckpt_dir, arch=LAUNCH_ARCH, seq=None):
    """:func:`launch_train` on every rank of the gloo world, as
    ``torchrun`` would start the launcher (``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK`` set; the launcher takes the running group)."""
    os.environ.update(WORLD_SIZE=str(dist.get_world_size()),
                      RANK=str(dist.get_rank()),
                      LOCAL_RANK=str(dist.get_rank()))
    return dict(launch_train(ckpt_dir, arch, seq), rank=dist.get_rank())


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _worker(rank, world, port, job, mesh_shape, extra, q):
    sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        q.put((rank, "ok", JOBS[job](mesh_shape, *extra)))
    except Exception:  # noqa: BLE001 — reported to the parent
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def scan_inputs(name):
    """The plain scan ``name`` ("ssd" or "wkv"), its inputs at a small size
    from numpy seed 3 (float32; the WKV's decay in (0.4, 0.9)), the weights
    of the output whose weighted sum the gradients are taken of, and its
    on_shards dims."""
    from repro_torch.kernels.mamba2_scan import ssd_chunked_plain
    from repro_torch.kernels.rwkv6_scan import wkv6_chunked_plain
    from repro_torch.sharding import SSD_DIMS, WKV_DIMS

    rng = np.random.default_rng(3)
    B, L, H = 4, 32, 4

    def f(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))
    if name == "ssd":
        P, N = 8, 16
        ins = (f(B, L, H, P), f(B, L, H, lo=0.05, hi=0.5), f(H, lo=-1.0,
                                                              hi=-0.1),
               f(B, L, N), f(B, L, N))
        return ssd_chunked_plain, ins, f(B, L, H, P), f(B, H, N, P), SSD_DIMS
    hd = 8
    ins = (f(B, L, H, hd), f(B, L, H, hd), f(B, L, H, hd),
           f(B, L, H, hd, lo=0.4, hi=0.9), f(H, hd))
    return wkv6_chunked_plain, ins, f(B, L, H, hd), f(B, H, hd, hd), WKV_DIMS


def scan_shards(mesh_shape):
    """Each plain scan through ``sharding.on_shards`` on a 2 x 2 mesh, its
    inputs' batch split over mesh dim 0 and their heads over dim 1 (an
    argument without the dim whole), against the scan on whole tensors:
    the largest difference of y, s_final and every input's gradient (of a
    weighted sum of y and s_final), over the largest element of the
    unsharded one, and the types the scan received and
    the gradients that entered and left it (each device's own tensors,
    never a DTensor)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.sharding import on_shards

    mesh = init_device_mesh("cpu", mesh_shape)
    out = {}
    for name in ("ssd", "wkv"):
        fn, ins, wy, ws, (head_dims, batch_dims, out_dims) = scan_inputs(name)
        seen = {"args": set(), "grads": set()}

        def spy(*args):
            seen["args"] |= {type(a).__name__ for a in args}
            for a in args:
                a.register_hook(
                    lambda g: seen["grads"].add(type(g).__name__))
            y, s = fn(*args)
            y.register_hook(lambda g: seen["grads"].add(type(g).__name__))
            return y, s

        whole = [t.clone().requires_grad_(True) for t in ins]
        y, s = fn(*whole)
        ((y * wy).sum() + (s * ws).sum()).backward()
        placed = []
        for t, bd, hd in zip(ins, batch_dims, head_dims):
            pl = [Shard(bd) if bd is not None else Replicate(),
                  Shard(hd) if hd is not None else Replicate()]
            placed.append(torch.distributed.tensor.distribute_tensor(
                t, mesh, pl).requires_grad_(True))
        yd, sd = on_shards(spy, head_dims, batch_dims, out_dims)(*placed)
        wyd = torch.distributed.tensor.distribute_tensor(
            wy, mesh, yd.placements)
        wsd = torch.distributed.tensor.distribute_tensor(
            ws, mesh, sd.placements)
        ((yd * wyd).sum() + (sd * wsd).sum()).backward()
        def rel(got, want):     # largest difference over the largest |want|
            return ((got - want).abs().max() / want.abs().max()).item()
        diff = {"y": rel(yd.full_tensor(), y),
                "s_final": rel(sd.full_tensor(), s)}
        for i, (a, b) in enumerate(zip(placed, whole)):
            diff[f"grad{i}"] = rel(a.grad.full_tensor(), b.grad)
        out[name] = {"diff": diff, "placements": [str(yd.placements),
                                                  str(sd.placements)],
                     "args": sorted(seen["args"]),
                     "grads": sorted(seen["grads"]),
                     "is_dtensor": [isinstance(t, DTensor)
                                    for t in (yd, sd)]}
    return out


JOBS = {"sharded_step": sharded_step, "compressed_reduce": compressed_reduce,
        "launch_dp": launch_dp, "scan_shards": scan_shards}


def main() -> int:
    job, shape = sys.argv[1], tuple(int(x) for x in sys.argv[2].split(","))
    extra = tuple(sys.argv[3:])
    world = math.prod(shape)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, port, job, shape, extra, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = sorted(q.get(timeout=240) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    errors = [r for r in results if r[1] != "ok"]
    if errors:
        print("ERROR " + "\n".join(e[2] for e in errors), flush=True)
        return 1
    print("RESULT " + json.dumps([r[2] for r in results]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

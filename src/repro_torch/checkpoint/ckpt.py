"""Asynchronous checkpointing over GENESYS pwrite (the counterpart of
``repro.checkpoint.ckpt``).

Writes are *relaxed-producer, non-blocking* syscalls (paper §4.1:
producers need the pre-barrier only), issued per leaf and coalesced by
the executor; ``Genesys.drain()`` — the paper §8.3 completion function —
is the commit barrier before the manifest rename, which makes the
checkpoint crash-consistent (a manifest either names a fully-written step
or doesn't exist).

The directory layout, the manifest and the leaf order are the
reference's, so either package restores the other's checkpoints: one
``leaf_NNNNN.bin`` of raw bytes per leaf, in ``jax.tree_util`` flatten
order (dict keys sorted, an :class:`~repro_torch.optim.OptState` as
``(m, v, count)``), and ``manifest.json`` with each leaf's shape and
dtype name. bf16 leaves are written as their 2-byte patterns under the
dtype name ``"bfloat16"``, as numpy's bf16 names itself on the JAX side.

A tree of DTensors (the data-parallel launcher's state) must hold each
leaf whole on every rank (replicated): global rank 0 alone writes it,
every rank waits at a barrier of the default process group until the
manifest is committed, and restore copies each leaf into every rank's
local tensor. A split leaf is refused.

Differences from the reference: restore copies each leaf into its
counterpart in ``tree_like`` in place (no shardings to restore onto); a
leaf travels in pieces of at most
:data:`IO_CHUNK` bytes, one PWRITE64/PREAD64 each, because Linux moves at
most 2 GiB - 4 KiB per call and a full-width leaf can be larger (the
reference issues one call per leaf and would write such a leaf short);
and each file is closed after the drain, not by a non-blocking CLOSE
right behind its writes: the executor's workers run bundles
concurrently, so such a CLOSE can run before the leaf's last PWRITE64,
which then fails and leaves the leaf short under a committed manifest.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.genesys import Genesys, Sys
from repro_torch.optim import OptState
from repro_torch.optim.adamw import leaves as flatten

IO_CHUNK = 1 << 30


def unflatten(like, leaves):
    """``leaves`` (an iterator, consumed in ``flatten`` order) in the
    structure of ``like``."""
    if isinstance(like, dict):
        return {k: unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, OptState):
        return OptState(unflatten(like.m, leaves), unflatten(like.v, leaves),
                        unflatten(like.count, leaves))
    return next(leaves)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A leaf's values on this rank: a DTensor's local tensor, which must
    be the whole leaf (replicated), or the tensor itself."""
    if not hasattr(t, "to_local"):
        return t
    local = t.to_local()
    if local.shape != t.shape:
        raise ValueError(f"a checkpoint takes whole leaves: this rank holds "
                         f"{tuple(local.shape)} of {tuple(t.shape)} "
                         f"({t.placements})")
    return local


def _shared(leaves) -> bool:
    """Whether the tree is the replicated state of every rank (it holds
    DTensors), so that one rank writes it for all."""
    return any(hasattr(t, "to_local") for t in leaves)


def _host_bytes(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor's bytes on the host as flat uint8, and its manifest dtype
    name."""
    t = _whole(t).detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint8).reshape(-1), \
            "bfloat16"
    a = t.cpu().numpy()
    return a.reshape(-1).view(np.uint8), str(a.dtype)


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """A host tensor viewing ``raw`` (uint8) as a leaf of ``dtype``."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(raw.view(np.dtype(dtype))).reshape(shape)


class CheckpointManager:
    def __init__(self, gsys: Genesys, directory: str, *, keep: int = 3):
        self.gsys = gsys
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.stats = {"saves": 0, "bytes": 0, "save_wall_s": 0.0,
                      "restores": 0}

    def _open(self, path: Path, flags: int, mode: int) -> int:
        ph = self.gsys.heap.register_bytes(str(path).encode())
        fd = self.gsys.call(Sys.OPEN, ph, flags, mode)
        self.gsys.heap.release(ph)
        if fd < 0:
            raise OSError(-fd, f"open {path}")
        return fd

    # ------------------------------------------------------------- save ----
    def save(self, step: int, tree) -> dict | None:
        """Write all leaves via non-blocking GENESYS pwrites, drain, then
        atomically commit the manifest; returns it. A tree of DTensors is
        written by global rank 0 alone (the others return None), and every
        rank returns once the manifest is committed.

        Every leaf's bytes sit in an arena extent from its copy until the
        drain, so the host holds the whole state at once (starcoder2-7b
        at full width, 8 layers, f32 parameters and moments: 26 GB)."""
        leaves = flatten(tree)
        if not _shared(leaves):
            return self._write(step, leaves)
        import torch.distributed as dist
        manifest = self._write(step, leaves) if dist.get_rank() == 0 \
            else None
        dist.barrier()
        return manifest

    def _write(self, step: int, leaves) -> dict:
        t0 = time.monotonic()
        step_dir = self.dir / f"step_{step:08d}"
        step_dir.mkdir(parents=True, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        handles = []          # payload extents live until the drain barrier
        fds = []              # so do the files: closed after it
        for i, leaf in enumerate(leaves):
            flat, dtype = _host_bytes(leaf)
            path = step_dir / f"leaf_{i:05d}.bin"
            fd = self._open(path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC,
                            0o644)
            # ONE staging copy into an arena extent; the pwrites go out
            # zero-copy off it
            nbytes = flat.size
            bh = self.gsys.heap.register_bytes(flat)
            del flat
            handles.append(bh)
            for off in range(0, nbytes, IO_CHUNK):
                # relaxed-producer non-blocking pwrite of the extent's
                # bytes [off, off + n) to the same offset of the file
                self.gsys.call(Sys.PWRITE64, fd, bh,
                               min(IO_CHUNK, nbytes - off), off, off,
                               blocking=False)
            fds.append(fd)
            manifest["leaves"].append({"file": path.name,
                                       "shape": list(leaf.shape),
                                       "dtype": dtype})
            self.stats["bytes"] += nbytes
        # §8.3 completion barrier, then atomic manifest commit
        self.gsys.drain()
        for bh in handles:    # writes are committed: extents go home
            self.gsys.heap.release(bh)
        for fd in fds:
            self.gsys.call(Sys.CLOSE, fd)
        tmp = step_dir / ".manifest.tmp"
        tmp.write_text(json.dumps(manifest))
        os.replace(tmp, step_dir / "manifest.json")
        self._gc()
        self.stats["saves"] += 1
        self.stats["save_wall_s"] += time.monotonic() - t0
        return manifest

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep]:
            sd = self.dir / f"step_{s:08d}"
            for f in sd.iterdir():
                f.unlink()
            sd.rmdir()

    # ---------------------------------------------------------- restore ----
    def list_steps(self) -> list[int]:
        out = []
        for d in self.dir.glob("step_*"):
            if (d / "manifest.json").exists():   # only committed steps
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, tree_like):
        """Restore into ``tree_like`` IN PLACE: each leaf is copied into its
        counterpart there, which must have the leaf's shape and dtype.
        Returns ``tree_like``'s tensors in its structure."""
        likes = flatten(tree_like)
        step_dir = self.dir / f"step_{step:08d}"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        if len(manifest["leaves"]) != len(likes):
            raise ValueError(f"checkpoint {step_dir} holds "
                             f"{len(manifest['leaves'])} leaves, the tree "
                             f"{len(likes)}")
        out = []
        for meta, like in zip(manifest["leaves"], likes):
            path = step_dir / meta["file"]
            nbytes = os.path.getsize(path)
            fd = self._open(path, os.O_RDONLY, 0)
            bh = self.gsys.heap.new_buffer(nbytes)
            for off in range(0, nbytes, IO_CHUNK):
                want = min(IO_CHUNK, nbytes - off)
                n = self.gsys.call(Sys.PREAD64, fd, bh, want, off, off)
                if n != want:
                    raise OSError(f"{path}: read {n} of {want} bytes at "
                                  f"{off}")
            self.gsys.call(Sys.CLOSE, fd)
            host = _from_bytes(self.gsys.heap.resolve(bh), meta["dtype"],
                               meta["shape"])
            if host.shape != like.shape or host.dtype != like.dtype:
                self.gsys.heap.release(bh)
                raise ValueError(f"{path}: {meta['dtype']} {meta['shape']} "
                                 f"does not fit {like.dtype} "
                                 f"{list(like.shape)}")
            # the copy to the leaf's place ends before the extent goes
            # home: a released extent can be re-carved
            with torch.no_grad():
                _whole(like).copy_(host)
            out.append(like)
            self.gsys.heap.release(bh)
        self.stats["restores"] += 1
        return unflatten(tree_like, iter(out))

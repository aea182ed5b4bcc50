"""Training loop with GENESYS-integrated services and fault tolerance (the
counterpart of ``repro.train.loop``).

Per step:
  * batch fetched through the GENESYS pread prefetch pipeline;
  * async checkpoint every ``ckpt_every`` steps (non-blocking pwrites,
    §8.3 drain at commit);
  * madvise(DONTNEED) hints to the host memory pool for staging buffers
    that are dead after the device copy (the miniAMR pattern, §7.2);
  * watchdog: steps that exceed ``step_deadline_s`` are logged as
    stragglers (timing via the GENESYS clock syscall);
  * crash/preemption recovery: ``resume()`` restores the latest committed
    checkpoint into the live tensors;
  * spans (``core/genesys/trace.py``'s named spans, always on): one
    ``step`` a step, the root, with its children ``load``
    (``next_batch``), ``stage`` (the pool's mmap/touch, the copy to the
    device, MADVISE), ``loss_read`` (the ``float(loss)`` sync),
    ``checkpoint`` when one is due, ``watchdog`` (the closing
    CLOCK_GETTIME and munmap), and the train step's ``forward``,
    ``backward`` and ``optimizer`` (``train.steps``), whose device marks
    are read after ``loss_read``. They land in ``gsys.tracer`` when
    GENESYS tracing is on (a step's syscalls then nest under them), else
    in the Trainer's own ring; :func:`recorded_spans` reads them out.

With ``rules`` (``sharding.ShardingRules`` on a mesh, the data-parallel
launcher's), the parameters are DTensors and each batch becomes one too,
split over the rules' batch axes by its rows; every rank holds the same
global batch, so a rank keeps its own rows of it. The loss a step returns
is then a DTensor, read whole.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.core.genesys import Genesys, Sys
from repro_torch.core.genesys.memory_pool import MADV_DONTNEED
from repro_torch.core.genesys.trace import SpanRecorder, Tracer
from repro_torch.optim.adamw import leaves
from repro_torch.sharding import named_sharding


# the span recorders of the process's last Trainers, for recorded_spans()
# (each holds its tracer's bounded ring, not the Trainer)
_RECORDERS: deque = deque(maxlen=8)
SPAN_RING = 1 << 14      # events of a Trainer's own ring: ~700 steps


def recorded_spans() -> list[dict]:
    """The closed spans of the process's last Trainers, oldest first, in
    ``time.time_ns()``'s clock (``torch.profiler``'s): ``name``, ``id``,
    ``parent``, ``index``, ``start_ns``, ``end_ns``, ``device_ns``
    (``trace.Tracer.closed_spans``). Ids are unique within one tracer."""
    seen, out = set(), []
    for rec in _RECORDERS:
        key = (id(rec.tracer), rec.channel.name)
        if key not in seen:
            seen.add(key)
            out += rec.closed()
    return sorted(out, key=lambda s: s["start_ns"])


@dataclass
class LoopStats:
    steps: int = 0
    straggler_steps: int = 0
    ckpts: int = 0
    losses: list = field(default_factory=list)


class Trainer:
    def __init__(self, gsys: Genesys, train_step, params, opt_state, loader,
                 *, ckpt: CheckpointManager | None = None,
                 ckpt_every: int = 50, step_deadline_s: float = 60.0,
                 rules=None):
        self.gsys = gsys
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.loader = loader
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.deadline = step_deadline_s
        self.device = leaves(params)[0].device     # batches go there
        self.rules = rules
        self.step = 0
        self.stats = LoopStats()
        self.spans = SpanRecorder(
            gsys.tracer if gsys.tracer is not None else Tracer(SPAN_RING),
            "train")
        _RECORDERS.append(self.spans)

    def resume(self) -> bool:
        """Restart: copy the latest committed checkpoint, if any, into the
        live parameters and optimizer state (in place)."""
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        self.ckpt.restore(latest, {"params": self.params,
                                   "opt": self.opt_state})
        self.step = latest
        return True

    def _place(self, t: torch.Tensor) -> torch.Tensor:
        """A batch tensor [B, S] on the parameters' device; with rules on
        a mesh, a DTensor split by rows over the batch axes."""
        t = t.to(self.device)
        if self.rules is None or self.rules.mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        mesh = self.rules.mesh
        sh = named_sharding(mesh, self.rules, "batch", "seq",
                            shape=tuple(t.shape))
        return distribute_tensor(t, mesh, sh.placements)

    def run(self, n_steps: int) -> LoopStats:
        for _ in range(n_steps):
            with self.spans.span("step"):
                self._step()
        self.gsys.drain()
        return self.stats

    def _step(self) -> None:
        spans = self.spans
        t0 = self.gsys.call(Sys.CLOCK_GETTIME, 0) / 1e6
        with spans.span("load"):
            batch = self.loader.next_batch()

        # stage through the host pool; release pages after device copy
        with spans.span("stage"):
            staging = self.gsys.pool.mmap(batch["tokens"].nbytes * 2)
            self.gsys.pool.touch(staging)
            tbatch = {k: self._place(torch.from_numpy(v))
                      for k, v in batch.items()}
            self.gsys.call(Sys.MADVISE, staging, 0, MADV_DONTNEED,
                           blocking=False)    # §7.2: weak + non-blocking

        self.params, self.opt_state, metrics = self.train_step(
            self.params, self.opt_state, tbatch)
        with spans.span("loss_read"):
            loss = metrics["loss"]
            if hasattr(loss, "full_tensor"):
                loss = loss.full_tensor()
            loss = float(loss)
        spans.settle()          # float() synced: the step's marks are done
        self.stats.losses.append(loss)
        self.step += 1
        self.stats.steps += 1

        if self.ckpt and self.step % self.ckpt_every == 0:
            with spans.span("checkpoint"):
                self.ckpt.save(self.step, {"params": self.params,
                                           "opt": self.opt_state})
            self.stats.ckpts += 1

        with spans.span("watchdog"):
            t1 = self.gsys.call(Sys.CLOCK_GETTIME, 0) / 1e6
            if t1 - t0 > self.deadline:
                self.stats.straggler_steps += 1
            self.gsys.pool.munmap(staging)

"""The training driver: one configuration trained on one traffic mix
through the program's own loop, ``Trainer.run`` over ``make_train_step``,
fed by ``GenesysDataLoader`` from a token shard in the run's TMPDIR.

Set-up builds the Trainer once, with weights made from the seed on the
device, and drives it through the mix's ``checked_steps`` steps; those
steps warm every shape, and what they produced (each step's loss, the
first gradient as AdamW got it, the parameters' change) is kept. The
window then runs whole steps of the same Trainer until ``seconds`` have
passed. After it, the program's state is freed and the plain reference
trains the same weights on the same rows from the shard, and the two are
compared (``bench.check``)."""
from __future__ import annotations

import gc
import importlib
import math
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench import check, traffic, weights
from bench import trace as tracing


@dataclass
class Job:
    """What ``bench/run.py`` hands a driver."""
    cfg: dict                  # bench/configs/<config>.json
    mix: dict                  # bench/traffic/<mix>.json
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float             # time.perf_counter() at the process's start
    limits: dict               # bench/limits/<workload>.json
    readers: dict = field(default_factory=dict)   # per-layer name -> read


@dataclass
class Run:
    """What a per-layer metric reads (``bench/metrics/<name>.py``)."""
    cfg: dict
    mix: dict
    steps: list                # (start, end) host seconds of window steps
    rows: int                  # rows a step
    seq: int
    loader_s: list             # host seconds of each window step's load
    counters: dict             # program counters' increase over the window
    trace: tracing.Trace | None

    @property
    def window_s(self) -> float:
        return self.steps[-1][1] - self.steps[0][0]


class TimedLoader:
    """The program's loader, with the benchmark's span around each
    ``next_batch`` (``spans``: ``("next_batch", start_ns, end_ns)``); keeps
    copies of the first ``keep`` batches."""

    def __init__(self, inner, keep: int, spans: list):
        self.inner = inner
        self.keep = keep
        self.kept: list = []
        self.spans = spans

    def next_batch(self):
        t0 = time.time_ns()
        batch = self.inner.next_batch()
        self.spans.append(("next_batch", t0, time.time_ns()))
        if len(self.kept) < self.keep:
            self.kept.append({k: v.copy() for k, v in batch.items()})
        return batch

    def close(self):
        self.inner.close()


def _paths(tree, prefix=""):
    """``path -> leaf`` of nested dicts."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_paths(v, p + "/"))
        else:
            out[p] = v
    return out


def _counters(ops) -> dict:
    return {n: getattr(ops, n).launches for n in dir(ops)
            if hasattr(getattr(ops, n), "launches")}


def _norms(leaves: dict, factor: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(t, dtype=torch.float64))
            * factor for k, t in leaves.items()}


@dataclass
class Prepared:
    """A Trainer after its checked steps, and what the comparison needs."""
    gsys: object
    work: str
    shard: np.ndarray
    layout: list
    model: object
    trainer: object
    loader: TimedLoader
    prog: dict                 # the program's readings of the checked steps
    ops: object                # the program's kernel module (counters)
    stamps: dict               # perf_counter() at the end of each phase

    def close(self) -> None:
        self.loader.close()
        self.gsys.shutdown()
        shutil.rmtree(self.work, ignore_errors=True)


def prepare(cfg: dict, mix: dict, seed: int, dev) -> Prepared:
    """Build the Trainer from the seed on ``dev`` and drive it through the
    mix's checked steps."""
    from repro_torch.config import Family, ModelConfig, TrainConfig
    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.data.pipeline import GenesysDataLoader, write_token_shard
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_api
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import make_train_step

    model = importlib.import_module(f"bench.reference.{cfg['family']}")
    hp = mix["optimizer"]
    checked = mix["checked_steps"]
    pc = dict(cfg["port_config"])
    pc["family"] = Family(pc["family"])
    pcfg = ModelConfig(**pc)
    layout = model.layout(cfg)
    meta = _paths(get_api(pcfg).init(pcfg, device="meta", master=True))
    want = {p: (tuple(s), torch.float32) for p, s, _, _ in layout}
    have = {p: (tuple(t.shape), t.dtype) for p, t in meta.items()}
    if want != have:
        raise RuntimeError(f"the program's parameters differ from the "
                           f"configuration's layout: program {have}, "
                           f"layout {want}")

    stamps = {"program_loaded": time.perf_counter()}
    work = tempfile.mkdtemp(prefix="bench-train-")
    gsys = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=200,
                                 coalesce_max=8))
    try:
        shard = traffic.token_shard(mix, cfg, seed)
        shard_path = os.path.join(work, "tokens.bin")
        write_token_shard(shard_path, shard)
        stamps["shard"] = time.perf_counter()
        w = weights.make(layout, seed, dev)
        params = w.tree()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps["weights"] = time.perf_counter()
        inner, opt = make_train_step(pcfg, TrainConfig(
            lr=hp["lr"], weight_decay=hp["weight_decay"], beta1=hp["beta1"],
            beta2=hp["beta2"], grad_clip=hp["grad_clip"],
            microbatches=mix["microbatches"], z_loss=hp["z_loss"]))

        spans: list = []

        def step(*args):
            t0 = time.time_ns()
            out = inner(*args)
            spans.append(("train_step", t0, time.time_ns()))
            return out

        loader = TimedLoader(GenesysDataLoader(
            gsys, [shard_path], batch=rows_a_step(mix), seq=mix["seq_len"],
            seed=seed), checked, spans)
        trainer = Trainer(gsys, step, params, opt.init(params), loader)
        trainer.run(1)
        stamps["first_step"] = time.perf_counter()
        prog = {"grad": _norms(_paths(trainer.opt_state.m),
                               1 / (1 - hp["beta1"]))}
        trainer.run(checked - 1)
        stamps["checked_steps"] = time.perf_counter()
        prog["losses"] = list(trainer.stats.losses[:checked])
        with torch.no_grad():
            prog["change"] = {k: float(torch.linalg.vector_norm(
                t - w.initial(k), dtype=torch.float64))
                for k, t in _paths(trainer.params).items()}
    except BaseException:
        gsys.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        raise
    return Prepared(gsys, work, shard, layout, model, trainer, loader, prog,
                    ops, stamps)


def rows_a_step(mix: dict) -> int:
    return mix["rows_per_microbatch"] * mix["microbatches"]


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(job: Job) -> dict:
    cfg, mix = job.cfg, job.mix
    dev = torch.device(job.device)
    cuda = dev.type == "cuda"
    checked = mix["checked_steps"]
    p = prepare(cfg, mix, job.seed, dev)
    try:
        trainer, loader = p.trainer, p.loader
        loader.spans.clear()        # the host spans of the window alone
        if cuda:
            torch.cuda.synchronize(dev)
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - job.started
        phases = {k: t - job.started for k, t in p.stamps.items()}
        phases["setup_s"] = setup_s

        prof = None
        if job.trace:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA if cuda
                else torch.profiler.ProfilerActivity.CPU])
            prof.start()
        before = _counters(p.ops)
        steps = []
        start_ns = time.time_ns()
        deadline = time.perf_counter() + job.seconds
        while not steps or steps[-1][1] < deadline:
            t0 = time.perf_counter()
            trainer.run(1)
            steps.append((t0, time.perf_counter()))
        end_ns = time.time_ns()
        counters = {k: v - before[k] for k, v in _counters(p.ops).items()}
        losses = trainer.stats.losses[checked:]
        if prof is not None:
            prof.stop()
        window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        peak = max(setup_peak, window_peak) if cuda else 0
        tr = (tracing.collect(prof, start_ns, end_ns, loader.spans) if prof
              else None)
        window = Run(cfg, mix, steps, rows_a_step(mix), mix["seq_len"],
                     [(b - a) / 1e9 for n, a, b in loader.spans
                      if n == "next_batch"], counters, tr)
    finally:
        p.close()
    shard, layout, model, prog, kept = (p.shard, p.layout, p.model, p.prog,
                                        p.loader.kept)
    del p, trainer, loader, prof
    free(dev)

    if job.trace:
        metrics = {}
        for name, read in job.readers.items():
            value = read(window)
            if value is not None:
                metrics[name] = value
    else:
        tokens = len(steps) * rows_a_step(mix) * mix["seq_len"]
        metrics = {"train_tokens_per_s": tokens / window.window_s,
                   "peak_mem_gib": window_peak / 2 ** 30,
                   "setup_s": setup_s}

    t0 = time.perf_counter()
    ref, rows_differ = reference(model, cfg, layout, job.seed, dev,
                                 mix["optimizer"], shard, kept, "f32")
    reference_s = time.perf_counter() - t0
    read = check.readings(prog, ref, rows_differ)
    correct, compared = check.judge(read, job.limits)
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
    out = {"correct": correct, "attempted": len(steps),
           "failed": sum(not math.isfinite(x) for x in losses),
           "metrics": metrics, "device": device}
    if tr is not None:
        out["breakdown"] = tracing.breakdown(tr)
    out["_setup"] = phases
    out["compared"] = compared
    out["_readings"] = {"program": prog, "reference": ref,
                        "leaves": read["_leaves"],
                        "reference_s": reference_s}
    return out


def reference(model, cfg, layout, seed, dev, hp, shard, kept, prec):
    """The plain reference's checked steps on the shard's own rows for the
    batches the loader handed over, from the same seed's weights. Returns
    its readings and how many ids of those batches differ from the
    shard's."""
    from bench.reference.common import exact_float32, train
    exact_float32()
    batches, differ = [], 0
    for b in kept:
        tok, lab, d = traffic.find_rows(shard, b["tokens"], b["labels"])
        differ += d
        batches.append((torch.from_numpy(np.ascontiguousarray(tok)).to(dev),
                        torch.from_numpy(np.ascontiguousarray(lab)).to(dev)))
    w = weights.make(layout, seed, dev)
    try:
        out = train(model, cfg, dict(w.leaves), batches, hp, prec, w.initial)
    finally:
        del w
        free(dev)
    return out, differ

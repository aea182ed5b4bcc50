"""The training loop's spans (``core/genesys/trace.py``'s named spans,
recorded by ``Trainer.run`` and the train step): the tree of a step, the
syscalls that nest under it with GENESYS tracing on, the Chrome export's
training track, the histograms by span name, the ring's wrap, the clock
shared with ``torch.profiler``, and the launcher's print. No JAX here: the
card test runs on the GPU machine with ``python -m pytest
tests/test_torch_train_spans.py -m cuda --noconftest``."""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.genesys import Genesys, GenesysConfig, Sys
from repro_torch.core.genesys import trace
from repro_torch.data.pipeline import GenesysDataLoader, write_token_shard
from repro_torch.kernels import ops
from repro_torch.launch.train import phase_line
from repro_torch.models import layers, transformer
from repro_torch.train.loop import Trainer, recorded_spans
from repro_torch.train.steps import make_train_step

torch.set_num_threads(1)

CHILDREN = {"load": 1, "stage": 1, "forward": 2, "backward": 2,
            "optimizer": 1, "loss_read": 1, "watchdog": 1}
PLAIN = ops.Kernels(attend=layers.flash_attention_xla)


def _trainer(g, tmp_path, device="cpu", ckpt_every=2, microbatches=2):
    shard = str(tmp_path / "tok.bin")
    write_token_shard(shard, np.random.default_rng(0).integers(
        0, 500, size=20_000).astype(np.uint32))
    cfg = get_config("starcoder2-7b").reduced()
    params = transformer.init(cfg, seed=0, device=device, master=True)
    ts, opt = make_train_step(cfg, TrainConfig(
        lr=1e-3, microbatches=microbatches), PLAIN)
    loader = GenesysDataLoader(g, [shard], batch=2, seq=16)
    ckpt = CheckpointManager(g, str(tmp_path / "ckpt"))
    return Trainer(g, ts, params, opt.init(params), loader, ckpt=ckpt,
                   ckpt_every=ckpt_every), loader


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of 2 microbatches, a checkpoint due after the second,
    GENESYS tracing off: the spans land in the Trainer's own ring."""
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    try:
        tr, loader = _trainer(g, tmp_path_factory.mktemp("spans"))
        tr.run(2)
        loader.close()
        yield tr
    finally:
        g.shutdown()


def _tree(spans):
    steps = [s for s in spans if s["name"] == "step"]
    return steps, {st["id"]: [s for s in spans if s["parent"] == st["id"]]
                   for st in steps}


def test_a_step_records_its_phases_under_one_step_span(trained):
    spans = trained.spans.closed()
    steps, children = _tree(spans)
    assert len(steps) == 2 and steps[0]["id"] != steps[1]["id"]
    assert all(st["parent"] == 0 for st in steps)
    for k, st in enumerate(steps):
        kids = children[st["id"]]
        want = dict(CHILDREN, **({"checkpoint": 1} if k == 1 else {}))
        assert {n: sum(s["name"] == n for s in kids) for n in want} == want
        assert len(kids) == sum(want.values())
        assert [s["index"] for s in kids if s["name"] == "forward"] == [0, 1]
        assert [s["index"] for s in kids if s["name"] == "backward"] == [0, 1]
        for s in kids:
            assert st["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= st["end_ns"]
            assert s["device_ns"] == 0          # no device marks on the CPU
    order = [s["name"] for s in children[steps[0]["id"]]]
    assert order == ["load", "stage", "forward", "backward", "forward",
                     "backward", "optimizer", "loss_read", "watchdog"]
    assert trained.spans.tracer is not None and len(spans) == 2 + 2 * 9 + 1


def test_the_trainers_spans_reach_recorded_spans(trained):
    got = recorded_spans()
    assert all(s in got for s in trained.spans.closed())
    assert all(a["start_ns"] <= b["start_ns"] for a, b in zip(got, got[1:]))


def test_latency_histograms_report_each_span_name(trained):
    tr = trained.spans.tracer
    hist = trace.latency_histograms(tr.events.snapshot(),
                                    tr.channel_names())["train"]
    want = dict(CHILDREN, step=1, checkpoint=1)
    assert set(hist) == set(want)
    for name, n in want.items():
        assert hist[name]["span"]["count"] == n * (1 if name == "checkpoint"
                                                   else 2)
        assert hist[name]["span"]["p50_us"] > 0


def test_the_step_records_nothing_outside_a_step_span(tmp_path):
    g = Genesys(GenesysConfig(n_workers=1))
    try:
        tr, loader = _trainer(g, tmp_path)
        before = len(recorded_spans())
        tr.train_step(tr.params, tr.opt_state, {
            k: torch.from_numpy(v) for k, v in loader.next_batch().items()})
        assert trace.current_recorder() is None
        assert len(recorded_spans()) == before
        loader.close()
    finally:
        g.shutdown()


def test_genesys_tracing_nests_the_steps_syscalls(tmp_path):
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8, trace=True))
    try:
        tr, loader = _trainer(g, tmp_path, ckpt_every=100, microbatches=1)
        assert tr.spans.tracer is g.tracer
        tr.run(1)
        loader.close()
        spans = tr.spans.closed()
        (step,), children = _tree(spans)
        ids = {s["name"]: s["id"] for s in children[step["id"]]}
        evs = g.tracer.events.snapshot()
        irq = evs[evs["ev"] == trace.EV_IRQ]

        def under(sysno):
            return irq[irq["sysno"] == int(sysno)]["aux"].tolist()
        assert ids["load"] in under(Sys.PREAD64)
        assert under(Sys.MADVISE) == [ids["stage"]]
        assert under(Sys.CLOCK_GETTIME) == [step["id"], ids["watchdog"]]
        out = g.export_chrome_trace(str(tmp_path / "t.json"))
    finally:
        g.shutdown()
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == out
    track = [e for e in out["traceEvents"] if e.get("pid") == 6
             and e["ph"] == "X"]
    names = {e["name"] for e in track}
    assert {"step", "load", "stage", "forward", "backward", "optimizer",
            "loss_read", "watchdog", "sys:PREAD64", "sys:MADVISE",
            "sys:CLOCK_GETTIME"} <= names
    st = next(e for e in track if e["name"] == "step")
    for e in track:
        if not e["name"].startswith("sys:"):
            assert st["ts"] <= e["ts"] and e["ts"] + e["dur"] <= \
                st["ts"] + st["dur"] + 1e-3
    clock = out["metadata"]["clock"]
    assert clock["time_ns"] == g.tracer.clock[1]
    assert g.telemetry()["trace"]["clock"]["time_ns"] == clock["time_ns"]
    assert not [e for e in out["traceEvents"] if e.get("pid") == 5
                and e["ph"] == "X"]


class _Marks:
    def begin(self):
        pass

    def end(self):
        pass

    def elapsed_ns(self):
        return 1234


def test_a_span_closed_after_the_ring_wraps_is_dropped_never_torn():
    tr = trace.Tracer(capacity=64)
    rec = trace.SpanRecorder(tr, "train")
    other = tr.channel("doorbell")
    with rec.span("step"):
        with rec.span("forward", _Marks()):
            for i in range(100):            # the ring wraps over BEGINs
                other.rec(trace.EV_IRQ, 0, i)
        with rec.span("optimizer", _Marks()):
            pass
        rec.settle()
    with rec.span("step") as sid:
        with rec.span("load"):
            pass
    spans = rec.closed()
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("optimizer", spans[0]["parent"]), ("step", 0), ("load", sid)]
    assert spans[0]["device_ns"] == 1234 and spans[1]["id"] == sid
    assert all(s["start_ns"] <= s["end_ns"] for s in spans)
    assert tr.events.dropped > 0


def test_profiler_events_lie_inside_their_span_in_its_clock():
    rec = trace.SpanRecorder(trace.Tracer(), "train")
    a = torch.randn(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("step"):
            with rec.span("forward"):
                torch.mm(a, a)
    fwd = next(s for s in rec.closed() if s["name"] == "forward")
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    assert fwd["start_ns"] <= mm.start_ns()
    assert mm.start_ns() + mm.duration_ns() <= fwd["end_ns"]


def test_the_launchers_phase_line():
    spans = [{"name": "step", "start_ns": 0, "end_ns": 4_000_000,
              "device_ns": 0},
             {"name": "forward", "start_ns": 0, "end_ns": 1_000_000,
              "device_ns": 3_000_000},
             {"name": "step", "start_ns": 0, "end_ns": 2_000_000,
              "device_ns": 0},
             {"name": "load", "start_ns": 0, "end_ns": 500_000,
              "device_ns": 0}]
    assert phase_line(spans) == ("step 3.000, forward 0.500 / 1.500, "
                                 "load 0.250")


def test_the_launcher_prints_phases_and_reissues(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    st = launch_train.main(["--arch", "starcoder2-7b", "--reduced",
                            "--device", "cpu", "--steps", "2", "--batch",
                            "2", "--seq", "16", "--microbatches", "2"])
    out = capsys.readouterr().out
    assert st.steps == 2 and "straggler_reissues=0" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("phases"))
    phases = line.split(": ", 1)[1]         # no device marks on the CPU
    assert "step " in phases and "forward " in phases
    assert " / " not in phases


@pytest.mark.cuda
def test_device_marks_and_the_clock_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device marks are CUDA events")
    g = Genesys(GenesysConfig(n_workers=2))
    try:
        tr, loader = _trainer(g, tmp_path, device="cuda", ckpt_every=100)
        tr.run(1)                               # warm
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            tr.run(1)
        loader.close()
    finally:
        g.shutdown()
    step = tr.spans.closed()[-10:]
    assert step[0]["name"] == "step"
    kernels = sorted(e.start_ns() for e in prof.profiler.kineto_results
                     .events() if e.device_type() == torch.autograd
                     .DeviceType.CUDA and not e.name().startswith("Mem")
                     and not e.is_user_annotation())
    fwd = next(s for s in step if s["name"] == "forward")
    assert kernels and kernels[0] >= fwd["start_ns"]
    for name in ("forward", "backward", "optimizer"):
        assert all(s["device_ns"] > 0 for s in step if s["name"] == name)
    assert all(s["device_ns"] == 0 for s in step
               if s["name"] not in ("forward", "backward", "optimizer"))

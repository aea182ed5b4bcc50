"""The six readers of the program's own spans (``bench/spans.py``) on a
synthetic traced window: two steps whose spans go into a real recorder of
the program and come back through ``repro_torch.train.loop.
recorded_spans``, the accessor a chip run reads, beside device intervals
laid out so that each gap begins in a known span."""
from __future__ import annotations

import importlib.util
import json
from collections import deque

import pytest

import bench_small as S
from bench import spans as bench_spans
from bench import trace as tracing
from bench.drivers.train import Run
from repro_torch.core.genesys import trace
from repro_torch.train import loop

SPEC = json.loads((S.ROOT / "BENCHMARK.json").read_text())
NEW = ("input_ms.train", "forward_ms.train", "backward_ms.train",
       "optimizer_ms.train", "enqueue_idle_ms.train",
       "boundary_idle_ms.train")
CELLS = ["starcoder2-7b.train_4k", "zamba2-2.7b.train_4k_rows2"]

# one step's host spans (ns from its start) and device marks; the device
# runs a copy at 95-100, the forward's kernels at 100-300 and 320-480 (a
# gap that begins in the host's forward), the backward's to 870, the
# optimizer's to 960 and the loss's reduction to 965
HOST = (("load", 0, 50, 0), ("stage", 50, 100, 0),
        ("forward", 100, 400, 380), ("backward", 400, 800, 390),
        ("optimizer", 800, 900, 90), ("loss_read", 900, 980, 0),
        ("watchdog", 980, 995, 0))
DEVICE = (("Memcpy HtoD", "gpu_memcpy", 95, 100),
          ("k_fwd0", "kernel", 100, 300), ("k_fwd1", "kernel", 320, 480),
          ("k_bwd", "kernel", 480, 870), ("k_opt", "kernel", 870, 960),
          ("k_loss", "kernel", 960, 965))
STEP = 1000


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "bench_run_spans", S.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.reader(name)


def _recorder(steps: int, offset: int = 0) -> trace.SpanRecorder:
    """A recorder of the program holding ``steps`` steps at ``offset``
    ns, its ring clock mapped one to one onto the profiler's."""
    tr = trace.Tracer()
    tr.clock = (0, 0)
    rec = trace.SpanRecorder(tr, "train")
    ch = rec.channel
    for k in range(steps):
        base = offset + k * STEP
        sid = tr.next_seq()
        ch.rec(trace.EV_SPAN_BEGIN, trace.span_sysno("step"), sid, 0,
               ts=base)
        for name, a, b, dev in HOST:
            kid = tr.next_seq()
            sysno = trace.span_sysno(name)
            ch.rec(trace.EV_SPAN_BEGIN, sysno, kid, sid, ts=base + a)
            ch.rec(trace.EV_SPAN_END, sysno, kid, dev, ts=base + b)
        ch.rec(trace.EV_SPAN_END, trace.span_sysno("step"), sid, 0,
               ts=base + STEP)
    return rec


def _run(steps: int = 2) -> Run:
    device = [(n, kind, k * STEP + a, k * STEP + b)
              for k in range(steps) for n, kind, a, b in DEVICE]
    tr = tracing.Trace(0, steps * STEP, device=device)
    return Run({}, {}, [(k * STEP / 1e9, (k + 1) * STEP / 1e9)
                        for k in range(steps)], 2, 4096, [], {}, tr)


@pytest.fixture()
def program(monkeypatch):
    """The program's recorders, as the readers find them."""
    recorders = deque([_recorder(2)])
    monkeypatch.setattr(loop, "_RECORDERS", recorders)
    return recorders


def test_each_reader_reads_its_spans(program):
    run = _run()
    got = {name: _reader(name)(run) for name in NEW}
    assert got == pytest.approx({
        "input_ms.train": 100e-6, "forward_ms.train": 380e-6,
        "backward_ms.train": 390e-6, "optimizer_ms.train": 90e-6,
        "enqueue_idle_ms.train": 20e-6,
        # gaps 0-95 (in load), 965-1095 and 1965-2000 (in loss_read)
        "boundary_idle_ms.train": 130e-6}, rel=1e-12)
    assert bench_spans.idle_by_span(run) == {"load": 95, "forward": 40,
                                             "loss_read": 165}


def test_the_idle_splits_sum_to_the_windows_idle_time(program):
    run = _run()
    split = (_reader("enqueue_idle_ms.train")(run)
             + _reader("boundary_idle_ms.train")(run)) * len(run.steps)
    idle_ms = _reader("idle.train")(run) / 100 * run.trace.window_s * 1e3
    assert split == pytest.approx(idle_ms, rel=0.01)


def test_the_phases_and_the_boundary_idle_make_the_step(program):
    run = _run()
    total = sum(_reader(n)(run) for n in (
        "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
        "boundary_idle_ms.train"))
    step_ms = run.window_s / len(run.steps) * 1e3
    assert total == pytest.approx(step_ms, rel=0.02)
    assert total != pytest.approx(step_ms, rel=1e-3)   # the copy, the loss


def test_spans_outside_the_window_are_not_read(monkeypatch):
    monkeypatch.setattr(loop, "_RECORDERS",
                        deque([_recorder(2, offset=10 * STEP)]))
    run = _run()
    assert all(_reader(name)(run) is None for name in NEW)


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(loop, "recorded_spans")     # an older program
    run = _run()
    assert all(_reader(name)(run) is None for name in NEW)


def test_an_untraced_run_reads_none(program):
    run = _run()
    run.trace = None
    assert all(_reader(name)(run) is None for name in NEW)


def test_every_new_metric_has_its_reader_and_both_cells():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    layers = {m["layer"] for m in SPEC["per_layer"]
              if m["name"] not in NEW}
    for name in NEW:
        m = entries[name]
        assert (S.BENCH / "metrics" / f"{name}.py").exists()
        assert callable(_reader(name))
        assert m["workloads"] == CELLS and m["moves"] == "train_tokens_per_s"
        assert m["layer"] in layers and m["unit"] == "ms"
        assert m["source"] == ("host_clock" if name == "input_ms.train"
                               else "device_trace")
    assert [m["name"] for m in SPEC["per_layer"][-len(NEW):]] == list(NEW)

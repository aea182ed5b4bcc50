"""The program's own spans of a traced window, for the per-layer metrics
that read them: ``repro_torch.train.loop.recorded_spans()``, the
Trainer's ``step`` spans and their phases (``load``, ``stage``,
``forward``, ``backward``, ``optimizer``, ``loss_read``, ``checkpoint``,
``watchdog``) in the profiler's clock, with the device nanoseconds
between the step's device marks. A program that records none (an older
commit) and a window that holds none both read as ``None``."""
from __future__ import annotations

# the train step's phases: a device gap that starts while the host is in
# one of them is the host's enqueue starving the card
STEP_PHASES = ("forward", "backward", "optimizer")


def in_window(run) -> list | None:
    """The program's closed spans that lie inside the traced window."""
    if run.trace is None or not run.steps:
        return None
    try:
        from repro_torch.train.loop import recorded_spans
    except ImportError:
        return None
    a, b = run.trace.start_ns, run.trace.end_ns
    got = [s for s in recorded_spans()
           if a <= s["start_ns"] and s["end_ns"] <= b]
    return got or None


def host_ms(run, names) -> float | None:
    """Host milliseconds a step in the spans named ``names``."""
    spans = in_window(run)
    if spans is None:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] in names)
    return ns / 1e6 / len(run.steps)


def device_ms(run, name: str) -> float | None:
    """Device milliseconds a step between the device marks of the spans
    named ``name``, the idle between them included."""
    spans = in_window(run)
    marked = [s for s in spans or () if s["name"] == name and s["device_ns"]]
    if not marked:
        return None
    return sum(s["device_ns"] for s in marked) / 1e6 / len(run.steps)


def idle_by_span(run) -> dict | None:
    """The window's device idle nanoseconds by the innermost program span
    the host held when each gap began (``"none"`` outside every span:
    between the Trainer's steps)."""
    spans = in_window(run)
    if spans is None:
        return None
    out: dict = {}
    for a, b in run.trace.gaps():
        held = [s for s in spans if s["start_ns"] <= a < s["end_ns"]]
        # the innermost: the latest to begin, the shorter of two that tie
        name = max(held, key=lambda s: (s["start_ns"], -s["end_ns"]))[
            "name"] if held else "none"
        out[name] = out.get(name, 0) + b - a
    return out


def idle_ms(run, in_step_phases: bool) -> float | None:
    """Device idle milliseconds a step in gaps that began inside one of
    the train step's phases (``in_step_phases``), or anywhere else."""
    by_span = idle_by_span(run)
    if by_span is None:
        return None
    ns = sum(v for k, v in by_span.items()
             if (k in STEP_PHASES) == in_step_phases)
    return ns / 1e6 / len(run.steps)

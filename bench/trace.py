"""The device trace of a measured window: ``torch.profiler`` with device
activity alone over the window (recording every host op would slow the
host-bound parts of a step and read as device idle), read from its raw
events, not per-op tables. Kernel, copy and fill intervals; the host spans
are the benchmark's own, taken on the host's clock."""
from __future__ import annotations

from dataclasses import dataclass, field

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """Device operations ``(name, kind, start_ns, end_ns)`` and the
    benchmark's host spans ``(name, start_ns, end_ns)`` inside the window
    ``[start_ns, end_ns]``, all in ``time.time_ns()``'s clock, which the
    profiler stamps its events in."""
    start_ns: int
    end_ns: int
    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def kernels(self) -> list:
        return [d for d in self.device if d[1] == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of their
        intervals, not their sum."""
        return union_ns([(d[2], d[3]) for d in self.device]) / 1e9

    def gaps(self) -> list:
        """Idle intervals ``(start_ns, end_ns)`` of the device."""
        out, at = [], self.start_ns
        for a, b in sorted((d[2], d[3]) for d in self.device):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.end_ns > at:
            out.append((at, self.end_ns))
        return out


def union_ns(intervals) -> int:
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _kind(e) -> str:
    """The event's activity: "kernel", "gpu_memcpy", "gpu_memset", or
    another, told by the event's device and name."""
    from torch.autograd import DeviceType
    if e.device_type() != DeviceType.CUDA:
        return "host"
    if e.is_user_annotation():
        return "gpu_user_annotation"
    if e.name().startswith("Memcpy"):
        return "gpu_memcpy"
    if e.name().startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def collect(prof, start_ns: int, end_ns: int, spans) -> Trace:
    """The device events of a stopped ``torch.profiler.profile`` and the
    host ``spans`` inside ``[start_ns, end_ns]``, each clipped to it."""
    def clip(a, b):
        return max(a, start_ns), min(b, end_ns)
    tr = Trace(start_ns, end_ns, spans=[(n, *clip(a, b)) for n, a, b in spans
                                        if b > start_ns and a < end_ns])
    seen = 0
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind not in DEVICE_KINDS:
            continue
        seen += 1
        a = e.start_ns()
        b = a + e.duration_ns()
        if b > start_ns and a < end_ns:
            tr.device.append((e.name(), kind, *clip(a, b)))
    if seen and not tr.device:
        raise RuntimeError(f"none of the profiler's {seen} device events "
                           f"lies in the window's host clock [{start_ns}, "
                           f"{end_ns}]")
    return tr


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    benchmark's host span that held at the start of each gap ("loop" where
    none did: the Trainer's own code between the load and the step)."""
    by_name: dict = {}
    for name, _, a, b in tr.device:
        key = name[:160]
        by_name[key] = by_name.get(key, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle: dict = {}
    spans = sorted(tr.spans, key=lambda s: s[1])
    for a, b in tr.gaps():
        held = [s[0] for s in spans if s[1] <= a < s[2]]
        key = held[-1] if held else "loop"
        idle[key] = idle.get(key, 0) + (b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps]}

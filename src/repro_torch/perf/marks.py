"""Device marks for the training loop's named spans
(``core/genesys/trace.py``'s ``SpanRecorder``): :class:`CudaMarks` times a
span on the current CUDA stream, and :func:`span` opens a child of the
thread's open span with them, or nothing where no span is open."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.genesys.trace import current_recorder


class CudaMarks:
    """A span's device time on the current stream: an event recorded at
    its start and one at its end (``trace.SpanRecorder``'s marks)."""

    __slots__ = ("start", "stop")

    def begin(self) -> None:
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def end(self) -> None:
        self.stop = torch.cuda.Event(enable_timing=True)
        self.stop.record()

    def elapsed_ns(self) -> int:
        return round(self.start.elapsed_time(self.stop) * 1e6)


def span(rec, name: str, cuda: bool):
    """The span ``name`` of recorder ``rec`` under the thread's open one,
    with device marks on a card; nothing where ``rec`` is None."""
    if rec is None:
        return contextlib.nullcontext()
    return rec.span(name, CudaMarks() if cuda else None)


def here(name: str, cuda: bool):
    """:func:`span` on the calling thread's recorder
    (``trace.current_recorder``)."""
    return span(current_recorder(), name, cuda)

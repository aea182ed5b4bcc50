"""backward_ms.train: device milliseconds a step between the train step's
``backward`` marks (CUDA events on the stream at the span's start and
end, read after the step's loss): each microbatch's backward, summed
over them, with the forward's recompute under remat "full" inside it.
The device's idle time inside them is included."""

from bench import spans


def read(run):
    return spans.device_ms(run, "backward")

"""optimizer_ms.train: device milliseconds a step between the train step's
``optimizer`` marks (CUDA events on the stream at the span's start and
end, read after the step's loss): the gradients' division by the
microbatches and AdamW's update. The device's idle time inside them is
included."""

from bench import spans


def read(run):
    return spans.device_ms(run, "optimizer")

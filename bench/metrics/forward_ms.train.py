"""forward_ms.train: device milliseconds a step between the train step's
``forward`` marks (CUDA events on the stream at the span's start and
end, read after the step's loss): the model's forward and loss over each
microbatch, summed over them. The device's idle time inside them is
included."""

from bench import spans


def read(run):
    return spans.device_ms(run, "forward")

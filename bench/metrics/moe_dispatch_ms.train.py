"""moe_dispatch_ms.train: device milliseconds a step between the marks of
the program's ``moe_dispatch`` spans (routing, top-k, the sort into the
table and its gather) and ``moe_combine`` spans (the gather back to token
order and the weighted sum), in the forward and in each recomputation
under remat, summed; the device's idle time inside them is included."""

from bench import spans


def read(run):
    got = [spans.device_ms(run, n) for n in ("moe_dispatch", "moe_combine")]
    if all(v is None for v in got):
        return None
    return sum(v for v in got if v is not None)

"""input_ms.train: host milliseconds a step in the Trainer's ``load`` span
(``next_batch``) and ``stage`` span (the host pool's mmap and touch, the
batch's copy to the device, MADVISE): the step's whole wait for its
batch, of which ``loader_ms.train`` sees the load alone."""

from bench import spans


def read(run):
    return spans.host_ms(run, ("load", "stage"))

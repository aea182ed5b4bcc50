"""enqueue_idle_ms.train: device idle milliseconds a step in gaps of the
device trace that begin while the host is inside the train step's
``forward``, ``backward`` or ``optimizer`` span: the host's enqueue of
the step leaving the card without work."""

from bench import spans


def read(run):
    return spans.idle_ms(run, in_step_phases=True)

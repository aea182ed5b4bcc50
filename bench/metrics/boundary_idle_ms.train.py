"""boundary_idle_ms.train: device idle milliseconds a step in gaps of the
device trace that begin anywhere but in the train step's ``forward``,
``backward`` and ``optimizer`` spans: in ``loss_read``, ``watchdog``,
``checkpoint``, ``load``, ``stage``, the ``step`` span's own time, or
between steps. With ``enqueue_idle_ms.train`` it sums to the window's
idle time (``idle.train``)."""

from bench import spans


def read(run):
    return spans.idle_ms(run, in_step_phases=False)

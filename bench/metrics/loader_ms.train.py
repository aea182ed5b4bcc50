"""loader_ms.train: host milliseconds a step spends in the loader's
``next_batch`` (the benchmark's span around the loader it hands the
Trainer), the window's total over its steps. ``Trainer.run`` loads after
the previous step's loss has been read, so this time is on the step's
critical path."""


def read(run):
    if not run.loader_s:
        return None
    return 1e3 * sum(run.loader_s) / len(run.steps)

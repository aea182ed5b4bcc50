"""Faults planted in the program underneath a run, for the checks that the
comparison catches them (``bench/calibrate.py``, ``bench/tests``). Each is
a context manager that patches the program in this process only:

- ``unchanged``: the optimizer returns parameters and state unchanged;
- ``half_batch``: half of a step's rows are left out and the loss is the
  mean over the rest (the first half of each microbatch's rows, or of the
  microbatches where each holds one row);
- ``loss_altered``: the loss is off by 2^-7 of itself where it is
  produced;
- ``token_altered``: the loader hands over a batch with one id changed."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def unchanged():
    from repro_torch.optim.adamw import AdamW, global_norm
    orig = AdamW.update

    def update(self, grads, state, params):
        return params, state, global_norm(grads)
    AdamW.update = update
    try:
        yield
    finally:
        AdamW.update = orig


@contextlib.contextmanager
def half_batch():
    from repro_torch.train import steps
    orig = steps.loss_fn
    calls = [0]

    def loss_fn(params, cfg, batch, tc, *args, **kw):
        rows = batch["tokens"].shape[0]
        if rows > 1:        # the microbatch's first half of its rows
            return orig(params, cfg, {k: v[:rows // 2]
                                      for k, v in batch.items()},
                        tc, *args, **kw)
        # one row a microbatch: the first half of the microbatches
        loss, aux = orig(params, cfg, batch, tc, *args, **kw)
        i = calls[0] % tc.microbatches
        calls[0] += 1
        keep = i < tc.microbatches // 2
        return loss * (2.0 if keep else 0.0), aux
    steps.loss_fn = loss_fn
    try:
        yield
    finally:
        steps.loss_fn = orig


@contextlib.contextmanager
def loss_altered():
    from repro_torch.train import steps
    orig = steps.cross_entropy

    def cross_entropy(*args, **kw):
        loss, nll = orig(*args, **kw)
        return loss * (1 + 2 ** -7), nll
    steps.cross_entropy = cross_entropy
    try:
        yield
    finally:
        steps.cross_entropy = orig


@contextlib.contextmanager
def token_altered():
    from repro_torch.data.pipeline import GenesysDataLoader
    orig = GenesysDataLoader.next_batch

    def next_batch(self):
        batch = orig(self)
        batch["tokens"][0, -1] = 1 if batch["tokens"][0, -1] == 0 else 0
        return batch
    GenesysDataLoader.next_batch = next_batch
    try:
        yield
    finally:
        GenesysDataLoader.next_batch = orig


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "loss_altered": loss_altered, "token_altered": token_altered}

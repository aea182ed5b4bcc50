"""The plain reference against the port's training step at small widths on
the CPU, and the comparison against the faults it has to catch: a fault
in the reference or in the check shows here before chip time is spent."""
from __future__ import annotations

import time

import pytest
import torch

import bench_small as S
from bench import check, faults
from bench.drivers import train

FAMILIES = ("starcoder2-7b", "zamba2-2.7b")
CPU = torch.device("cpu")


def _readings(cfg, mix, seed):
    p = train.prepare(cfg, mix, seed, CPU)
    p.close()
    ref, differ = train.reference(p.model, cfg, p.layout, seed, CPU,
                                  mix["optimizer"], p.shard, p.loader.kept,
                                  "f32")
    return check.readings(p.prog, ref, differ)


@pytest.mark.parametrize("mix", ["train_4k", "train_4k_rows2"])
@pytest.mark.parametrize("name", FAMILIES)
def test_reference_follows_the_port_in_float32(name, mix):
    """In float32 compute the two differ by rounding alone."""
    r = _readings(S.small_config(name, "float32"), S.small_mix(mix),
                  2 ** 31 + 9)
    assert r["loss"] < 1e-5
    assert r["grad"] < 1e-4
    assert r["change"] < 1e-4
    assert r["rows"] == 0


# limits for the small float32 runs: far above their rounding (above), far
# below what each fault reads
LIMITS = {"loss": {"limit": 1e-4}, "grad": {"limit": 1e-3},
          "change": {"limit": 1e-3}, "rows": {"limit": 0}}


CELLS = [("starcoder2-7b", "train_4k"), ("zamba2-2.7b", "train_4k_rows2")]


def _run(cell, fault=None):
    name, mix = cell
    job = train.Job(cfg=S.small_config(name),
                    mix=S.small_mix(mix), seed=2 ** 31 + 77, seconds=0.2,
                    trace=False, device="cpu", started=time.perf_counter(),
                    limits=LIMITS)
    if fault is None:
        return train.run(job)
    with faults.FAULTS[fault]():
        return train.run(job)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: ".".join(c))
def test_an_unbroken_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                   "setup_s"}
    assert list(out)[-2:] == ["compared", "_readings"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: ".".join(c))
def test_a_broken_run_is_not_correct(cell, fault):
    out = _run(cell, fault)
    assert not out["correct"], out["compared"]

"""On the card, at the cells' widths and rows but fewer layers (one zamba2
period), on three seeds: the program passes each cell's limits, and the
control (the reference computed in float8, put in the program's place)
fails them. Run on the GPU machine with ``python -m pytest bench/tests -m
cuda``; skipped elsewhere."""
from __future__ import annotations

import importlib.util
import json

import pytest
import torch

import bench_small as S
from bench import calibrate, check

_spec = importlib.util.spec_from_file_location("bench_run", S.BENCH / "run.py")
run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run)

CELLS = {"starcoder2-7b.train_4k": 2, "zamba2-2.7b.train_4k_rows2": 6}
SPEC = json.loads((S.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_where_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = run.cell(SPEC, workload)
    cfg, mix, limits = c["cfg"], c["mix"], c["limits"]
    cfg["num_hidden_layers"] = cfg["port_config"]["n_layers"] = \
        CELLS[workload]
    dev = torch.device("cuda:0")
    for i, seed in enumerate((2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)):
        got = {r["side"]: r for r in calibrate.readings_for(
            cfg, mix, seed, dev, n_control=3, n_faults=0, index=i)}
        assert check.judge(got["program"], limits)[0], got["program"]
        assert not check.judge(got["control"], limits)[0], got["control"]

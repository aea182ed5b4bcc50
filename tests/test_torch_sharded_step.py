"""A sharded step against the one-device step: reduced starcoder2-7b in
f32 on 4 gloo processes, parameters, batch and cache as DTensors placed by
``sharding.rules_for`` on a (2, 2) mesh (and on a (1, 4) one, where the
KV heads are replicated to the tensor-parallel degree, kv_rep 2). One
train step's loss and grad norm and six greedy decode steps' tokens must
equal the port's on plain tensors (loss to 1e-5)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("mesh,kv_rep", [("2,2", 1), ("1,4", 2)])
def test_sharded_step_equals_the_one_device_step(mesh, kv_rep):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "torch_dist_jobs.py"),
                        "sharded_step", mesh],
                       env=env, capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stdout[-3000:] + r.stderr[-3000:]
    ranks = json.loads(line[0][len("RESULT "):])
    assert len(ranks) == 4
    for res in ranks:
        assert res["kv_rep"] == kv_rep
        one, sharded = res["train_False"], res["train_True"]
        assert abs(sharded["loss"] - one["loss"]) <= 1e-5, res
        assert abs(sharded["grad_norm"] - one["grad_norm"]) <= \
            1e-5 * one["grad_norm"], res
        assert res["tokens_True"] == res["tokens_False"]

"""Data parallelism in the training launcher: ``launch.train`` on 2 gloo
ranks (as ``torchrun`` starts it, through ``tests/torch_dist_jobs.py``)
against the launcher in one process on the same shard, reduced
internlm2-20b in float32. Every step's loss agrees to 1e-5; the
checkpoint is written once (by rank 0: the other rank issues no PWRITE64)
and both ranks resume from it; the resumed step's losses agree too."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

import torch_dist_jobs  # noqa: E402

LOSS_ATOL = 1e-5


def _syscalls(printed: str) -> dict:
    line = next(ln for ln in printed.splitlines() if "GENESYS: " in ln)
    return ast.literal_eval(re.search(r"GENESYS: (\{.*?\})", line).group(1))


def test_two_ranks_train_as_one_process(tmp_path, monkeypatch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "torch_dist_jobs.py"),
                        "launch_dp", "2", str(tmp_path / "dp")],
                       env=env, capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stdout[-3000:] + r.stderr[-3000:]
    ranks = json.loads(line[0][len("RESULT "):])
    assert [res["rank"] for res in ranks] == [0, 1]

    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    one = torch_dist_jobs.launch_train(str(tmp_path / "one"))
    steps = torch_dist_jobs.LAUNCH_STEPS
    assert len(one["first"]["losses"]) == steps
    for res in ranks:
        for run in ("first", "resumed"):
            got, want = res[run]["losses"], one[run]["losses"]
            assert len(got) == len(want)
            assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_ATOL, \
                (run, got, want)
        assert res["first"]["ckpts"] == 1
        assert f"resumed from step {steps}" in res["resumed"]["printed"]
    # one checkpoint on disk, written by rank 0 alone
    step_dirs = sorted(p.name for p in (tmp_path / "dp").iterdir())
    assert step_dirs == [f"step_{steps:08d}"]
    assert (tmp_path / "dp" / step_dirs[0] / "manifest.json").exists()
    writes = [_syscalls(res["first"]["printed"]).get("PWRITE64", 0)
              for res in ranks]
    assert writes[0] > 0 and writes[1] == 0
    assert writes[0] == _syscalls(one["first"]["printed"])["PWRITE64"]

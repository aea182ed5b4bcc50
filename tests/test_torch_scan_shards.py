"""The recurrent scans on each device's shards (``sharding.on_shards``),
as the dry run and the data-parallel training launcher run them.

* On a gloo world of 2 x 2 ranks (``tests/torch_dist_jobs.py
  scan_shards``), the plain SSD scan and the plain WKV, their inputs' batch
  split over one mesh dim and their heads over the other, equal the scans
  on whole tensors: y and s_final, and every input's gradient (those of
  ``A [H]``, ``Bm``, ``Cm`` and ``u [H, hd]``, which some shards share, are
  each device's partial sums). The scan itself sees only plain tensors,
  forward and backward.
* zamba2-2.7b's ``train_4k`` dry-run cell on the production mesh's fake
  world, cut to 6 layers and one microbatch, runs to its end with the plain
  SSD scan receiving each device's own (fake) tensors, and the gradients
  entering and leaving it in the backward are local too: no op of the scan,
  the ``aten.flip`` of its cumsum's backward included, is dispatched on a
  DTensor (torch 2.11 has no sharding strategy for that flip).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# y and s_final: the same rows and heads in the same order; the shared
# inputs' gradients: partial sums added over the shards in another order
REL_TOL = 1e-5


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def scan_shards():
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "torch_dist_jobs.py"),
                        "scan_shards", "2,2"], env=_env(),
                       capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(line[0][len("RESULT "):])


@pytest.mark.parametrize("scan", ["ssd", "wkv"])
def test_scans_on_shards_equal_the_unsharded_scans(scan_shards, scan):
    for rank in scan_shards:
        got = rank[scan]
        assert got["is_dtensor"] == [True, True]
        # y [B,L,H,.] split by rows and heads, s_final [B,H,.,.] likewise
        assert got["placements"] == ["(Shard(dim=0), Shard(dim=2))",
                                     "(Shard(dim=0), Shard(dim=1))"]
        assert set(got["diff"]) == {"y", "s_final", "grad0", "grad1",
                                    "grad2", "grad3", "grad4"}
        assert max(got["diff"].values()) <= REL_TOL, got["diff"]
        assert got["args"] == ["Tensor"] and got["grads"] == ["Tensor"]


CELL = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import mamba2_scan

    seen = {"calls": 0, "dtensor_args": 0, "grads": []}
    plain = mamba2_scan.ssd_chunked_plain

    def spy(*args, **kwargs):
        seen["calls"] += 1
        seen["dtensor_args"] += sum(isinstance(a, DTensor) for a in args)
        for a in args:
            if isinstance(a, torch.Tensor) and a.requires_grad:
                a.register_hook(lambda g: seen["grads"].append(
                    type(g).__name__))
        y, s = plain(*args, **kwargs)
        y.register_hook(lambda g: seen["grads"].append(type(g).__name__))
        return y, s

    # before the dry run imports it into its plain kernels
    mamba2_scan.ssd_chunked_plain = spy
    from repro_torch.launch.dryrun import run_cell
    out = run_cell("zamba2-2.7b", "train_4k", False, microbatches=1,
                   cfg_overrides={"n_layers": 6})
    print("CELL " + json.dumps({"status": out["status"],
                                "error": out.get("error"), **seen}))
""")


def test_dryrun_train_cell_runs_the_scan_on_local_shards():
    r = subprocess.run([sys.executable, "-c", CELL], env=_env(),
                       capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("CELL ")]
    assert line, r.stdout[-2000:] + r.stderr[-4000:]
    out = json.loads(line[0][len("CELL "):])
    assert out["status"] == "ok", out["error"]
    # 6 layers, each run again by the backward (zamba2 trains under remat
    # "full"), every call on local tensors
    assert out["calls"] == 12 and out["dtensor_args"] == 0
    # the backward went through the scan: one gradient in per layer, one
    # out per differentiable input (x, dt, A, Bm, Cm), none a DTensor
    assert len(out["grads"]) == 6 * 6
    assert set(out["grads"]) == {"FakeTensor"}

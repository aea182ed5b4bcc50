"""Data parallelism in the training launcher: ``launch.train`` on 2 gloo
ranks (as ``torchrun`` starts it, through ``tests/torch_dist_jobs.py``)
against the launcher in one process on the same shard, in float32, for
reduced internlm2-20b (dense), zamba2-2.7b (hybrid: the SSD scan on each
rank's rows), rwkv6-3b (SSM: the WKV on each rank's rows) and
moonshot-v1-16b-a3b (MoE: the expert products on each rank's dispatch
groups; at the launcher's 4 x 32 tokens one group spans both ranks' rows,
at 4 x 256 each rank holds two whole groups). Every step's loss agrees to
1e-5; the checkpoint is written once (by rank 0: the other rank makes no
PWRITE64) and both ranks resume from it; the resumed step's losses agree
too. The encoder-decoder, which neither launcher trains, is refused by
name."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

import pytest  # noqa: E402
import torch_dist_jobs  # noqa: E402

LOSS_ATOL = 1e-5


def _syscalls(printed: str) -> dict:
    line = next(ln for ln in printed.splitlines() if "GENESYS: " in ln)
    return ast.literal_eval(re.search(r"GENESYS: (\{.*?\})", line).group(1))


@pytest.mark.parametrize("arch,seq", [
    pytest.param("internlm2-20b", None, id="internlm2-20b"),
    pytest.param("zamba2-2.7b", None, id="zamba2-2.7b"),
    pytest.param("rwkv6-3b", None, id="rwkv6-3b"),
    # 4 x 32 tokens: one dispatch group of 128 across both ranks' rows
    pytest.param("moonshot-v1-16b-a3b", None, id="moonshot-v1-16b-a3b"),
    # 4 x 256 tokens: four groups of 256, two whole groups on each rank
    pytest.param("moonshot-v1-16b-a3b", "256",
                 id="moonshot-v1-16b-a3b-seq256")])
def test_two_ranks_train_as_one_process(tmp_path, monkeypatch, arch, seq):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "torch_dist_jobs.py"),
                        "launch_dp", "2", str(tmp_path / "dp"), arch]
                       + ([] if seq is None else [seq]),
                       env=env, capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stdout[-3000:] + r.stderr[-3000:]
    ranks = json.loads(line[0][len("RESULT "):])
    assert [res["rank"] for res in ranks] == [0, 1]

    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    one = torch_dist_jobs.launch_train(str(tmp_path / "one"), arch, seq)
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


@pytest.mark.parametrize("arch,family", [("seamless-m4t-medium", "encdec")])
def test_data_parallel_refuses_moe_and_the_encoder_decoder(monkeypatch,
                                                           arch, family):
    """Under a ``torchrun`` world the launcher refuses the encoder-decoder
    before it joins the group or builds anything, naming the family and
    the arch: neither launcher trains it, since the loader gives tokens
    and no frames."""
    from repro_torch.config import Family
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    assert get_config(arch).family == Family(family)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=f"not {family} \\({arch}\\)"):
        train.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_launcher_prints_its_kernel_launches(monkeypatch, capsys):
    """The launcher's last line counts the training kernels' launches in
    its run (the card's smoke reads it under ``torchrun``): none on the
    CPU, where the plain versions run."""
    from repro_torch.launch import train

    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    train.main(["--arch", "internlm2-20b", "--reduced", "--device", "cpu",
                "--steps", "1", "--batch", "2", "--seq", "32"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    launches = ast.literal_eval(
        re.search(r"^kernel launches: (\{.*\})$", last).group(1))
    assert launches == dict.fromkeys(
        ("flash_attention_fwd", "flash_attention_bwd", "mamba2_ssd_fwd",
         "mamba2_ssd_bwd", "rwkv6_wkv_fwd", "rwkv6_wkv_bwd", "gmm_fwd",
         "gmm_bwd"), 0)

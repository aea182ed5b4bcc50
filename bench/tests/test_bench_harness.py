"""The benchmark's harness on the CPU: every cell resolves by name to its
files, a cell added as files is picked up with no file edited, the
yardstick's counts, the import guard, and the trace's arithmetic."""
from __future__ import annotations

import ast
import hashlib
import importlib.util
import json
import shutil

import pytest

import bench_small as S
from bench import check, flops
from bench import trace as tracing

BENCH, ROOT = S.BENCH, S.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _load_run(bench_dir):
    spec = importlib.util.spec_from_file_location("bench_run_copy",
                                                  bench_dir / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_workload_resolves_to_its_files(workload):
    run = _load_run(BENCH)
    c = run.cell(SPEC, workload)
    assert c["cfg"]["name"] == c["entry"]["config"]
    assert c["mix"]["name"] == c["entry"]["traffic"]
    assert (BENCH / "drivers" / f"{c['mix']['driver']}.py").exists()
    assert (BENCH / "reference" / f"{c['cfg']['family']}.py").exists()
    compared = set(c["limits"]) & set(check.NUMBERS)
    assert "rows" in compared and c["limits"]["rows"]["limit"] == 0
    for name in compared:
        lim = c["limits"][name]
        if name != "rows":
            assert lim["lower"] < lim["limit"] < lim["upper"]
    for name in c["per_layer"]:
        assert callable(run.reader(name))
    conf = next(x for x in SPEC["configs"] if x["name"] == c["cfg"]["name"])
    assert conf["file"] == f"bench/configs/{c['cfg']['name']}.json"
    assert conf["reduced"] == c["cfg"]["reduced"]
    for key in c["cfg"]["reduced"]:
        assert key in c["cfg"]["published"]


def test_every_metric_has_a_reader_and_every_cell_its_metrics():
    names = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", names)) <= names
    for w in names:
        assert any(w in m.get("workloads", [w]) for m in SPEC["per_layer"])


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    copy = tmp_path / "repo"
    shutil.copytree(BENCH, copy / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(copy / "bench")
    cfg = S.load("configs", "starcoder2-7b")
    cfg.update(name="starcoder2-7b-16l", num_hidden_layers=16)
    (copy / "bench/configs/starcoder2-7b-16l.json").write_text(
        json.dumps(cfg))
    mix = S.load("traffic", "train_4k")
    mix.update(name="train_8k", seq_len=8192, microbatches=1)
    (copy / "bench/traffic/train_8k.json").write_text(json.dumps(mix))
    (copy / "bench/limits/starcoder2-7b-16l.train_8k.json").write_text(
        (BENCH / "limits/starcoder2-7b.train_4k.json").read_text())
    (copy / "bench/metrics/steps.train.py").write_text(
        "def read(run):\n    return len(run.steps)\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "starcoder2-7b-16l.train_8k",
                              "config": "starcoder2-7b-16l",
                              "traffic": "train_8k", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "steps.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "training loop",
                              "moves": "train_tokens_per_s"})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    run = _load_run(copy / "bench")
    c = run.cell(spec, "starcoder2-7b-16l.train_8k")
    assert c["cfg"]["num_hidden_layers"] == 16
    assert c["mix"]["seq_len"] == 8192
    assert "steps.train" in c["per_layer"]
    assert run.reader("steps.train")(type("R", (), {"steps": [1, 2]})) == 2
    after = _digest(copy / "bench")
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("name,layers,params,model_flops", [
    ("starcoder2-7b", 8, 2.190e9, 1.039e14),
    ("zamba2-2.7b", 18, 0.987e9, 4.717e13),
])
def test_counts_match_the_smoke(name, layers, params, model_flops):
    """The smoke's figures at its depths, to the digits it printed."""
    cfg = dict(S.load("configs", name), num_hidden_layers=layers)
    assert round(flops.param_count(cfg) / 1e9, 3) == params / 1e9
    assert float(f"{flops.model_flops(cfg, 2, 4096):.3e}") == model_flops


def test_the_program_counts_the_same_parameters():
    from repro_torch.config import Family, ModelConfig
    for name in ("starcoder2-7b", "zamba2-2.7b"):
        cfg = S.load("configs", name)
        pc = dict(cfg["port_config"], family=Family(cfg["family"]))
        assert ModelConfig(**pc).param_count() == flops.param_count(cfg)


def test_least_times_are_below_the_measured_kernels():
    """K3 at hd 128 took 0.3628 ms forward and 1.2481 ms backward, K4 at
    zamba2's shape 0.3502 and 1.0486 ms (PERF.md's kernel table): the
    least times must lie below them."""
    f, b = flops.flash_attention_least_s(S.load("configs", "starcoder2-7b"),
                                         1, 4096)
    assert 0.10e-3 < f < 0.3628e-3 and 0.25e-3 < b < 1.2481e-3
    f, b = flops.mamba2_ssd_least_s(S.load("configs", "zamba2-2.7b"), 1, 4096)
    assert 0.01e-3 < f < 0.3502e-3 and 0.01e-3 < b < 1.0486e-3


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_import_guard(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names
        assert "repro_torch" not in path.read_text()


def test_trace_arithmetic():
    tr = tracing.Trace(0, 100, device=[
        ("void fa_fwd_wgmma<128>(...)", "kernel", 10, 30),
        ("sm90_xmma_gemm_bf16", "kernel", 20, 40),
        ("void at::native::elementwise_kernel<...>", "kernel", 50, 55),
        ("Memcpy HtoD", "gpu_memcpy", 60, 62)],
        spans=[("next_batch", 0, 10), ("train_step", 45, 70)])
    assert tr.busy_s() == 37e-9
    assert tr.gaps() == [(0, 10), (40, 50), (55, 60), (62, 100)]
    b = tracing.breakdown(tr)
    assert b["idle_gaps"][0] == ["train_step", 43e-9]
    assert dict(b["idle_gaps"]) == {"train_step": 43e-9,
                                    "next_batch": 10e-9, "loop": 10e-9}
    assert {n for n, _ in b["device_ops"][:2]} == {
        "sm90_xmma_gemm_bf16", "void fa_fwd_wgmma<128>(...)"}
    run = _load_run(BENCH)
    window = type("R", (), {"trace": tr, "steps": [0, 1], "counters": {}})
    assert run.reader("elementwise_ms.train")(window) == 5e-6 / 2
    assert run.reader("idle.train")(window) == pytest.approx(63.0)
    assert run.reader("flash_attention_roofline.train")(window) is None


def test_result_line_gives_each_metric_its_unit(capsys):
    run = _load_run(BENCH)
    units = {m["name"]: m["unit"]
             for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    out = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"train_tokens_per_s": 1.5, "setup_s": 2.5},
           "device": {"platform": "gpu"},
           "compared": {"loss": {"value": float("inf"), "limit": 1e-3}},
           "_readings": {}}
    assert run.emit(out, units) == 0
    stdout, stderr = capsys.readouterr()
    line = json.loads(stdout.strip().splitlines()[-1])
    assert line["metrics"] == {
        "train_tokens_per_s": {"value": 1.5, "unit": "tokens/s"},
        "setup_s": {"value": 2.5, "unit": "s"}}
    assert list(line)[-1] == "compared"
    assert stderr.strip().splitlines()[-1].startswith("loss ")


def test_mamba2_draws_are_their_laws():
    import math

    import torch

    from bench import weights
    w = weights.make([("A_log", (4000,), "log_uniform", (1.0, 16.0)),
                      ("dt_bias", (4000,), "dt_bias", (1e-3, 0.1, 1e-4))],
                     2 ** 31 + 5, "cpu")
    A = w.leaves["A_log"].exp()
    dt = torch.nn.functional.softplus(w.leaves["dt_bias"].double())
    assert 1.0 <= A.min() and A.max() <= 16.0
    assert abs(A.mean().item() - 8.5) < 0.3
    assert 1e-3 * (1 - 1e-4) <= dt.min() and dt.max() <= 0.1 * (1 + 1e-4)
    assert abs(dt.log().mean().item() - math.log(1e-2)) < 0.1
    assert torch.equal(w.initial("dt_bias"), w.leaves["dt_bias"])

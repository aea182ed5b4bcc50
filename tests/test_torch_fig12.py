"""Fig. 12's serving workload (``benchmarks/fig12_serving.py``) through the
port at reduced size on the CPU, as the reference runs it: reduced
internlm2-20b in float32, weights from the JAX package bridged by
``weights.py``. The workload is ``chip_smoke.py``'s phase 5c, which runs it
at full width on the card; these tests drive the same functions.

* Part B (shared-prefix reuse, PWRITE64 spill, PREAD64_FIXED revival)
  through the port's engine and through the JAX package's engine on the
  same requests: prefix hits, prefill steps saved, spill writes, fixed
  reads, evictions and every request's tokens equal; and the phase's own
  run, whose revived sharer decodes what a fresh engine decodes.
* Part A (open-loop churn, closed buckets against the continuous engine)
  with 16 requests: every tag gets its budget from both servers."""
import dataclasses
import importlib.util
import os
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.genesys import Genesys as JaxGenesys
from repro.core.genesys import GenesysConfig as JaxGenesysConfig
from repro.models.registry import get_api
from repro.serving.engine import make_engine as jax_engine
from repro.sharding import rules_for
from repro_torch.configs import get_config
from repro_torch.core.genesys import Genesys, GenesysConfig
from repro_torch.kernels import ops
from repro_torch.serving.engine import make_engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

# chip_smoke.py lives at the repository's root, beside tests/
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

F32 = dict(params_dtype="float32", compute_dtype="float32",
           kv_cache_dtype="float32")
ARCH = "internlm2-20b"
PART_A_REQUESTS = 16


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **F32)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **F32)
    params, _ = get_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    return jcfg, cfg, params, tparams


def _engine_args(tmp, name):
    return dict(n_slots=2, n_blocks=12, block_size=chip_smoke.FIG12_BLOCK,
                max_blocks_per_seq=10, spill_path=os.path.join(tmp, name))


def test_part_b_matches_the_jax_engine(model, mesh11):
    jcfg, cfg, params, tparams = model
    with tempfile.TemporaryDirectory() as tmp:
        g = JaxGenesys(JaxGenesysConfig(n_workers=2))
        try:
            with mesh11:
                want = chip_smoke.fig12_part_b_run(
                    jax_engine(jcfg, rules_for(jcfg, mesh11), params, gsys=g,
                               **_engine_args(tmp, "jax.spill")),
                    cfg.vocab_size, chip_smoke.FIG12_SHARERS)
        finally:
            g.shutdown()
        g = Genesys(GenesysConfig(n_workers=2))
        try:
            got = chip_smoke.fig12_part_b_run(
                make_engine(cfg, tparams, gsys=g,
                            **_engine_args(tmp, "torch.spill")),
                cfg.vocab_size, chip_smoke.FIG12_SHARERS)
        finally:
            g.shutdown()
    for key in ("prefix_hits", "prefill_steps_saved", "spill_writes",
                "fixed_reads", "evictions", "prefix", "tokens"):
        assert got[key] == want[key], key
    assert got["prefix_hits"] > 0
    assert got["spill_writes"] >= 1 and got["fixed_reads"] >= 1
    assert len(got["tokens"]) == chip_smoke.FIG12_SHARERS + 3


def test_phase_part_b_revives_what_a_fresh_engine_decodes(model):
    _, cfg, _, tparams = model
    out = chip_smoke.fig12_part_b(torch, cfg, tparams, n_sharers=3,
                                  counters=(ops.paged_decode_attention,))
    assert out["prefix_hits"] > 0 and out["fixed_reads"] >= 1
    assert out["tokens"]["revived"] == out["fresh_tokens"]
    assert out["fresh_evictions"] == 0
    # CPU tensors take the plain versions: no kernel launches
    assert out["launches"]["paged_decode_attention"] == 0


def test_part_a_answers_every_tag_with_its_budget(model):
    _, cfg, _, tparams = model
    out = chip_smoke.fig12_part_a(torch, cfg, tparams,
                                  n_requests=PART_A_REQUESTS)
    want = out["budgets"]
    assert len(want) == PART_A_REQUESTS
    assert all(2 <= b <= 6 or 28 <= b <= 32 for b in want.values())
    for name in ("closed", "continuous"):
        replies = out[f"{name}_replies"]
        assert {t: len(r) for t, r in replies.items()} == want, name
        assert out[f"{name}_tokens_out"] == sum(want.values())
    assert out["continuous_occupancy"] > 1.0
    assert out["kv_rss_peak_bytes"] > 0

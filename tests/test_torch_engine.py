"""The port's continuous-batching engine against the JAX package's engine
on the same requests and bridged weights (reduced starcoder2-7b, float32):
slot churn, shared-prefix reuse with spill and revival through the port's
own Genesys (PWRITE64 out, PREAD64_FIXED back), and admission
backpressure. Mirrors tests/test_pagedkv.py's engine tests."""
import dataclasses
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_api
from repro.serving.engine import make_engine as jax_engine
from repro.sharding import rules_for
from repro_torch.configs import get_config
from repro_torch.core.genesys import Genesys, GenesysConfig
from repro_torch.serving.engine import make_engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

BS = 4
F32 = dict(params_dtype="float32", compute_dtype="float32",
           kv_cache_dtype="float32")


@pytest.fixture()
def tgsys():
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    yield g
    g.shutdown()


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_config("starcoder2-7b").reduced(), **F32)
    cfg = dataclasses.replace(get_config("starcoder2-7b").reduced(), **F32)
    params, _ = get_api(jcfg).init(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    return jcfg, cfg, params, tparams


def _run(eng, reqs):
    """Admit requests as slots free up (arrivals land mid-decode) and
    step until all retire; returns {meta: generated tokens}."""
    done = {}
    pending = list(enumerate(reqs))
    while pending or eng.n_active:
        while pending and eng.admit(pending[0][1][0], pending[0][1][1],
                                    meta=pending[0][0]):
            pending.pop(0)
        for meta, gen in eng.step():
            done[meta] = gen
    return done


def test_engine_matches_jax_engine_with_churn(model, mesh11):
    jcfg, cfg, params, tparams = model
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, cfg.vocab_size, size=rng.integers(1, 10))
             .astype(np.int32), int(rng.integers(2, 6))) for _ in range(6)]
    with mesh11:
        want = _run(jax_engine(jcfg, rules_for(jcfg, mesh11), params,
                               n_slots=3, n_blocks=32, block_size=BS), reqs)
    eng = make_engine(cfg, tparams, n_slots=3, n_blocks=32, block_size=BS)
    assert eng.arenas["k"].device.type == "cpu"
    assert _run(eng, reqs) == want
    assert eng.stats.admitted == 6 and eng.stats.retired == 6
    assert eng.stats.occupancy() > 1.0
    assert eng.pool.stats.blocks_in_use == 0


def test_engine_prefix_reuse_and_spill_revival_match_jax(model, mesh11,
                                                         tgsys):
    """The second request hits the sealed prefix in the arena; a long
    request then evicts it to the spill file (the block's bytes leave
    the torch arena), and the third revives it through PREAD64_FIXED and
    _install_block — all three continuations equal the JAX engine's."""
    jcfg, cfg, params, tparams = model
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, cfg.vocab_size, size=2 * BS).tolist()
    p1 = np.asarray(prefix + [17], np.int32)
    p2 = np.asarray(prefix + [23], np.int32)
    with mesh11:
        jeng = jax_engine(jcfg, rules_for(jcfg, mesh11), params, n_slots=2,
                          n_blocks=12, block_size=BS)
        want1 = _run(jeng, [(p1, 3)])[0]
        want2 = _run(jeng, [(p2, 3)])[0]
    spill = tempfile.mktemp(suffix=".kvspill")
    eng = make_engine(cfg, tparams, n_slots=2, n_blocks=12, block_size=BS,
                      max_blocks_per_seq=10, gsys=tgsys, spill_path=spill)
    assert eng.block_bytes() == 2 * cfg.n_layers * BS * cfg.n_kv_heads * \
        cfg.hd * 4
    try:
        assert eng.admit(p1, 3)
        (_, gen1), = eng.drain()
        assert eng.admit(p2, 3)     # hits the sealed prefix in-arena
        (_, gen2), = eng.drain()
        assert eng.stats.prefill_steps_saved == 2 * BS
        assert eng.pool.stats.prefix_hits == 2
        assert eng.admit(np.asarray([5], np.int32), 10 * BS)   # evicts
        eng.drain()
        assert eng.pool.stats.spill_writes >= 1
        assert eng.admit(p2, 3)     # PREAD64_FIXED + _install_block
        (_, gen3), = eng.drain()
        assert eng.pool.stats.fixed_reads >= 1
    finally:
        if os.path.exists(spill):
            os.unlink(spill)
    assert gen1 == want1
    assert gen2 == want2 and gen3 == want2


def test_block_bytes_roundtrip_bf16(model):
    """A bf16 block leaves as raw bytes (numpy has no bf16) and comes back
    bit-identical into another block."""
    cfg = dataclasses.replace(model[1], compute_dtype="bfloat16",
                              kv_cache_dtype="bfloat16")
    eng = make_engine(cfg, model[3], n_slots=1, n_blocks=4, block_size=BS)
    eng.arenas["k"].normal_()
    eng.arenas["v"].normal_()
    payload = eng._extract_block(2)
    assert len(payload) == eng.block_bytes()
    eng._install_block(3, payload)
    for n in ("k", "v"):
        assert torch.equal(eng.arenas[n][:, 3], eng.arenas[n][:, 2])


def test_engine_admission_backpressure(model):
    """admit() returns False — claiming nothing — on slot or block
    exhaustion, and the request succeeds after retirements."""
    _, cfg, _, tparams = model
    eng = make_engine(cfg, tparams, n_slots=2, n_blocks=9, block_size=BS,
                      max_blocks_per_seq=4)
    assert eng.admit(np.asarray([3], np.int32), 2 * BS)   # 2 blocks
    assert eng.admit(np.asarray([4], np.int32), 2 * BS)
    in_use = eng.pool.stats.blocks_in_use
    assert not eng.admit(np.asarray([5], np.int32), 2)    # slots full
    assert eng.pool.stats.blocks_in_use == in_use
    eng.drain()
    assert eng.admit(np.asarray([5], np.int32), 2)
    with pytest.raises(ValueError):                       # table width
        eng.admit(np.asarray([6], np.int32), 5 * BS)
    eng.drain()
    assert eng.pool.stats.blocks_in_use == 0

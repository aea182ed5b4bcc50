"""The port's gradient compression against the JAX package's: int8_ef's
blocks, scales and carried error bit for bit on 20 seeded trees, the
bf16 round trip, and the compressed reduce over 8 gloo processes (pod 2 x
data 4), held to the reference's bound (``test_system.py``: err < 0.2)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import compress_tree as j_compress
from repro.optim.compression import decompress_tree as j_decompress
from repro_torch.optim.compression import compress_tree, decompress_tree

ROOT = Path(__file__).resolve().parents[1]


def _tree(seed):
    """Leaves of uneven sizes (a tail block), scales 1e-3 to 1e3, a zero
    block and an error state."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3)
    g = {"w": (rng.standard_normal((37, 19)) * scale).astype(np.float32),
         "b": {"c": rng.standard_normal(513).astype(np.float32),
               "z": np.zeros((2, 256), np.float32)}}
    e = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.01 * scale).astype(
            np.float32), g)
    return g, e


@pytest.mark.parametrize("seed", range(20))
def test_int8_ef_equals_the_reference_bit_for_bit(seed):
    g, e = _tree(seed)
    (tdef, qs), jerr = j_compress(jax.tree_util.tree_map(jnp.asarray, g),
                                  "int8_ef",
                                  jax.tree_util.tree_map(jnp.asarray, e))
    payload, err = compress_tree(jax.tree_util.tree_map(torch.from_numpy, g),
                                 "int8_ef",
                                 jax.tree_util.tree_map(torch.from_numpy, e))
    ours = [payload["b"]["c"], payload["b"]["z"], payload["w"]]
    assert len(qs) == len(ours)
    for (q, s, shape), (tq, ts, tshape) in zip(qs, ours):
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert tuple(shape) == tshape
        assert np.array_equal(np.asarray(q), tq.numpy())
        assert np.array_equal(np.asarray(s), ts.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(jerr),
                    [err["b"]["c"], err["b"]["z"], err["w"]]):
        assert np.array_equal(np.asarray(a), b.numpy())
    deq = decompress_tree(payload, "int8_ef")
    jdeq = j_decompress((tdef, qs), "int8_ef")
    for a, b in zip(jax.tree_util.tree_leaves(jdeq),
                    [deq["b"]["c"], deq["b"]["z"], deq["w"]]):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_int8_ef_carries_the_quantisation_residual():
    g, _ = _tree(3)
    tg = jax.tree_util.tree_map(torch.from_numpy, g)
    payload, err = compress_tree(tg, "int8_ef")
    deq = decompress_tree(payload, "int8_ef")
    for k in ("w",):
        scale = tg[k].abs().max() / 127.0 + 1e-12
        assert (deq[k] - tg[k]).abs().max() <= scale * 1.01
        torch.testing.assert_close(err[k], tg[k] - deq[k], atol=1e-6,
                                   rtol=0)


def test_bf16_compression_roundtrip():
    g = {"a": torch.ones(4, 4) * 1.5}
    payload, _ = compress_tree(g, "bf16")
    assert payload["a"].dtype == torch.bfloat16
    out = decompress_tree(payload, "bf16")
    assert out["a"].dtype == torch.float32
    assert torch.equal(out["a"], torch.full((4, 4), 1.5))


def test_none_passes_through_and_unknown_raises():
    g = {"a": torch.ones(3)}
    assert compress_tree(g, "none") == (g, None)
    assert decompress_tree(g, "none") is g
    with pytest.raises(ValueError):
        compress_tree(g, "fp4")


def test_compressed_crosspod_reduce_on_8_gloo_processes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "torch_dist_jobs.py"),
                        "compressed_reduce", "2,4"],
                       env=env, capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stdout[-3000:] + r.stderr[-3000:]
    ranks = json.loads(line[0][len("RESULT "):])
    assert len(ranks) == 8
    for res in ranks:
        assert res["bf16"] < 0.2, res     # 8 shards x bf16 ulp(5.12)/2
        assert res["int8_ef"] < 0.2, res

"""The port's kernel module against the JAX package: the plain paged decode
attention (what the CUDA kernel is held to) against the reference's
``paged_attention_xla`` and its Pallas kernel in interpret mode, and the
plain paged KV append against ``ops.update_kv_buffer``. Inputs come from
numpy with a seed; the same arrays go to both packages. The CUDA kernels
themselves are held to these plain versions on the GPU by
``chip_smoke.py``: they have no CPU mode, and the GPU machine has no JAX
for this suite's conftest."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

F32_ATOL = 3e-5     # f32 sums in another order than XLA's, over <= 64 keys


def _pack_pages(k, v, block_size, n_blocks, rng):
    """Scatter dense k,v [B,KV,S,hd] into a shuffled block arena
    [NB,BS,KV,hd] + block tables [B,MB] (as tests/test_kernels.py)."""
    B, KV, S, hd = k.shape
    MB = S // block_size
    bt = rng.permutation(np.arange(1, n_blocks))[:B * MB]
    bt = bt.reshape(B, MB).astype(np.int32)
    kp = np.zeros((n_blocks, block_size, KV, hd), k.dtype)
    vp = np.zeros_like(kp)
    for b in range(B):
        for p in range(MB):
            lo = p * block_size
            kp[bt[b, p]] = np.moveaxis(k[b, :, lo:lo + block_size], 0, 1)
            vp[bt[b, p]] = np.moveaxis(v[b, :, lo:lo + block_size], 0, 1)
    return kp, vp, bt


def _case(B, H, KV, S, hd, bs, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, KV, S, hd), dtype=np.float32)
    v = rng.standard_normal((B, KV, S, hd), dtype=np.float32)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    kp, vp, bt = _pack_pages(k, v, bs, B * (S // bs) + 3, rng)
    return q, kp, vp, bt, lens


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,H,KV,S,hd,bs,ns", [
    (2, 4, 2, 64, 32, 8, 4),      # GQA, splits divide the pages evenly
    (1, 8, 8, 48, 16, 4, 3),      # MHA, 12 pages over 3 splits
    (3, 2, 1, 32, 32, 16, 4),     # MQA, want 4 splits of 2 pages -> 2
    (2, 4, 2, 64, 32, 8, 1),      # single split (plain paged decode)
    (2, 9, 1, 48, 32, 16, 3),     # G = 9, not a power of two (starcoder2)
])
def test_plain_paged_decode_matches_xla_and_pallas(B, H, KV, S, hd, bs, ns):
    q, kp, vp, bt, lens = _case(B, H, KV, S, hd, bs, seed=B * 100 + H)
    got = tops.paged_decode_attention(*_t(q, kp, vp, bt, lens)).numpy()
    xla = jlayers.paged_attention_xla(
        jnp.asarray(q)[:, None], jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(lens))[:, 0]
    pallas = jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), n_splits=ns, interpret=True)
    np.testing.assert_allclose(got, np.asarray(xla), atol=F32_ATOL)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=F32_ATOL)
    # the layer-shaped entry [B,1,H,hd] is the same function
    tq, tk, tv, tbt, tl = _t(q, kp, vp, bt, lens)
    np.testing.assert_array_equal(
        tlayers.paged_attention_xla(tq[:, None], tk, tv, tbt, tl)[:, 0]
        .numpy(), got)


def test_plain_paged_decode_garbage_beyond_lens_is_masked():
    """Pages past lens[b] — pointing at arbitrary blocks — must not leak
    into the output."""
    B, H, KV, S, hd, bs = 2, 2, 2, 32, 16, 8
    q, kp, vp, bt, _ = _case(B, H, KV, S, hd, bs, seed=8)
    lens = np.asarray([9, 16], np.int32)
    o1 = tops.paged_decode_attention(*_t(q, kp, vp, bt, lens))
    dead = [bt[b, p] for b in range(B)
            for p in range(-(-int(lens[b]) // bs), S // bs)]
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[dead] = 999.0
    vp2[dead] = -999.0
    o2 = tops.paged_decode_attention(*_t(q, kp2, vp2, bt, lens))
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-6)


@pytest.mark.parametrize("qdt", [np.float32, "bfloat16"])
def test_plain_paged_decode_int8_matches_xla(qdt):
    """int8 arenas dequantise by 1/QSCALE in q's dtype, as the serve path's
    reference does (the Pallas kernel does not divide: held to XLA only)."""
    B, H, KV, S, hd, bs = 2, 9, 1, 48, 32, 16
    q, _, _, bt, lens = _case(B, H, KV, S, hd, bs, seed=21)
    rng = np.random.default_rng(22)
    kp = rng.integers(-127, 128, size=(bt.size + 3, bs, KV, hd), dtype=np.int8)
    vp = rng.integers(-127, 128, size=kp.shape, dtype=np.int8)
    tq = torch.from_numpy(q)
    jq = jnp.asarray(q)
    if qdt == "bfloat16":
        tq, jq = tq.to(torch.bfloat16), jq.astype(jnp.bfloat16)
    got = tops.paged_decode_attention(tq, *_t(kp, vp, bt, lens)).float()
    want = jlayers.paged_attention_xla(
        jq[:, None], jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens))[:, 0].astype(jnp.float32)
    # bf16: both round one output to bf16 from f32 sums in other orders
    atol = F32_ATOL if qdt == np.float32 else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_plain_update_kv_buffer_matches_reference_and_drops():
    """Each row lands at its flat slot; the out-of-range slot (the
    reference's mode="drop") is dropped, not wrapped or clamped."""
    NB, BS, KV, hd, B = 5, 4, 2, 8, 3
    rng = np.random.default_rng(9)
    kp0 = rng.standard_normal((NB, BS, KV, hd), dtype=np.float32)
    vp0 = rng.standard_normal((NB, BS, KV, hd), dtype=np.float32)
    kn = rng.standard_normal((B, KV, hd), dtype=np.float32)
    vn = rng.standard_normal((B, KV, hd), dtype=np.float32)
    slots = np.asarray([6, 13, NB * BS + 1], np.int32)
    jk, jv = jops.update_kv_buffer(jnp.asarray(kp0), jnp.asarray(vp0),
                                   jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(slots))
    tk, tv = _t(kp0.copy(), vp0.copy())
    out_k, out_v = tops.update_kv_buffer(tk, tv, *_t(kn, vn, slots))
    assert out_k is tk and out_v is tv          # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    changed = np.flatnonzero((tk.numpy() != kp0).reshape(NB * BS, -1)
                             .any(axis=1))
    assert changed.tolist() == [6, 13]


def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    before = (tops.paged_decode_attention.launches,
              tops.update_kv_buffer.launches)
    q, kp, vp, bt, lens = _case(1, 4, 2, 16, 8, 4, seed=3)
    tq, tk, tv, tbt, tl = _t(q, kp, vp, bt, lens)
    tops.paged_decode_attention(tq, tk, tv, tbt, tl)
    tops.update_kv_buffer(tk, tv, torch.zeros(1, 2, 8), torch.zeros(1, 2, 8),
                          torch.zeros(1, dtype=torch.int32))
    assert (tops.paged_decode_attention.launches,
            tops.update_kv_buffer.launches) == before
    assert tops.paged_decode_attention is tda.paged_decode_attention

"""The port's kernel module against the JAX package: the plain paged decode
attention (what the K1 CUDA kernel is held to) against the reference's
``paged_attention_xla`` and its Pallas kernel in interpret mode; the plain
dense decode attention (K2) against the Pallas ``decode_attention``,
``ref.decode_attention_ref``, ``decode_attention_xla`` and
``decode_attention_two_part``; and the plain paged KV append against
``ops.update_kv_buffer``. Inputs come from numpy with a seed; the same
arrays go to both packages. The CUDA kernels themselves are held to these
plain versions on the GPU by ``chip_smoke.py``: they have no CPU mode, and
the GPU machine has no JAX for this suite's conftest.

The deliberate differences from a reference (ROADMAP Queue 3) each have a
test here that states both outputs: int8 K/V divided by QSCALE (the
Pallas kernels do not divide), negative append slots dropped (the
reference wraps them), and a row with nothing to attend giving 0 (the
XLA references give NaN, the Pallas kernels the mean of V)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
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
    counted = (tops.paged_decode_attention, tops.decode_attention,
               tops.update_kv_buffer)
    before = [f.launches for f in counted]
    q, kp, vp, bt, lens = _case(1, 4, 2, 16, 8, 4, seed=3)
    tq, tk, tv, tbt, tl = _t(q, kp, vp, bt, lens)
    tops.paged_decode_attention(tq, tk, tv, tbt, tl)
    tops.decode_attention(tq, tk[None, 0], tv[None, 0], tl)
    tops.update_kv_buffer(tk, tv, torch.zeros(1, 2, 8), torch.zeros(1, 2, 8),
                          torch.zeros(1, dtype=torch.int32))
    assert [f.launches for f in counted] == before
    assert tops.paged_decode_attention is tda.paged_decode_attention
    assert tops.decode_attention is tda.decode_attention


# ------------------------------------------------------------ K2: dense ----

def _dense(B, H, KV, S, hd, seed, lens_lo=1):
    """q [B,H,hd], a carried-layout cache k,v [B,S,KV,hd], lens [B] and a
    new token k_new/v_new [B,KV,hd], f32 from numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    lens = rng.integers(lens_lo, S + 1, size=B).astype(np.int32)
    kn = rng.standard_normal((B, KV, hd), dtype=np.float32)
    vn = rng.standard_normal((B, KV, hd), dtype=np.float32)
    return q, k, v, lens, kn, vn


def _pallas_layout(x):
    """[B,S,KV,hd] (carried) -> [B,KV,S,hd] (the Pallas kernel's)."""
    return jnp.asarray(np.ascontiguousarray(np.swapaxes(x, 1, 2)))


@pytest.mark.parametrize("B,H,KV,S,hd,bk", [     # tests/test_kernels.py's
    (2, 8, 2, 1024, 64, 512),
    (1, 4, 4, 512, 128, 128),
    (3, 2, 1, 256, 32, 256),
])
def test_plain_dense_decode_matches_pallas_and_ref(B, H, KV, S, hd, bk):
    q, k, v, lens, _, _ = _dense(B, H, KV, S, hd, seed=S + B)
    got = tops.decode_attention(*_t(q, k, v, lens)).numpy()
    pallas = jops.decode_attention(jnp.asarray(q), _pallas_layout(k),
                                   _pallas_layout(v), jnp.asarray(lens),
                                   block_k=bk, interpret=True)
    want = jref.decode_attention_ref(jnp.asarray(q), _pallas_layout(k),
                                     _pallas_layout(v), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (3, 9, 1, 64, 32),      # G = 9 (starcoder2); one row attends the token
    (2, 4, 2, 48, 16),      # a row past capacity: lens > S
])
def test_plain_dense_decode_with_new_token_matches_two_part(B, H, KV, S, hd):
    """The carried branch's two-part softmax: cache below lens, then the
    new token, without writing it first."""
    q, k, v, lens, kn, vn = _dense(B, H, KV, S, hd, seed=H * S, lens_lo=0)
    lens[0] = 0 if H == 9 else S + 3
    got = tops.decode_attention(*_t(q, k, v, lens, kn, vn)).numpy()
    want = jlayers.decode_attention_two_part(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kn)[:, None], jnp.asarray(vn)[:, None],
        jnp.asarray(lens))[:, 0]
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL)
    # the layer-shaped entries [B,1,H,hd] are the same functions
    tq, tk, tv, tl, tkn, tvn = _t(q, k, v, lens, kn, vn)
    np.testing.assert_array_equal(tlayers.decode_attention_two_part(
        tq[:, None], tk, tv, tkn[:, None], tvn[:, None], tl)[:, 0].numpy(),
        got)
    np.testing.assert_array_equal(
        tlayers.decode_attention_xla(tq[:, None], tk, tv, tl)[:, 0].numpy(),
        tops.decode_attention(tq, tk, tv, tl).numpy())


def test_plain_dense_decode_covers_the_tail_pallas_drops():
    """S = 768 with the default block_k 512: the Pallas grid takes
    nk = S // 512 = 1 block and never sees positions 512-767. The port
    covers the tail and matches ``decode_attention_xla``; Pallas equals
    the same attention with lens cut to 512."""
    B, H, KV, S, hd = 3, 4, 2, 768, 32
    q, k, v, _, _, _ = _dense(B, H, KV, S, hd, seed=768)
    lens = np.asarray([300, 700, 768], np.int32)
    got = tops.decode_attention(*_t(q, k, v, lens)).numpy()
    xla = jlayers.decode_attention_xla(jnp.asarray(q)[:, None],
                                       jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(lens))[:, 0]
    np.testing.assert_allclose(got, np.asarray(xla), atol=F32_ATOL)
    pallas = np.asarray(jops.decode_attention(
        jnp.asarray(q), _pallas_layout(k), _pallas_layout(v),
        jnp.asarray(lens), interpret=True))
    cut = tops.decode_attention(*_t(q, k, v, np.minimum(lens, 512))).numpy()
    np.testing.assert_allclose(pallas, cut, atol=F32_ATOL)
    np.testing.assert_allclose(pallas[0], got[0], atol=F32_ATOL)
    assert np.abs(pallas[1:] - got[1:]).max() > 1e-2    # the tail it drops


@pytest.mark.parametrize("qdt", [np.float32, "bfloat16"])
@pytest.mark.parametrize("with_new", [False, True])
def test_plain_dense_decode_int8_matches_carried_branch(qdt, with_new):
    """An int8 cache is dequantised by 1/QSCALE in q's dtype, as the
    carried branch does before ``decode_attention_two_part``; the new
    token is attended unquantised, in q's dtype."""
    B, H, KV, S, hd = 2, 9, 1, 48, 32
    q, _, _, lens, kn, vn = _dense(B, H, KV, S, hd, seed=23)
    rng = np.random.default_rng(24)
    k = rng.integers(-127, 128, size=(B, S, KV, hd), dtype=np.int8)
    v = rng.integers(-127, 128, size=k.shape, dtype=np.int8)
    jdt = jnp.float32 if qdt == np.float32 else jnp.bfloat16
    tdt = torch.float32 if qdt == np.float32 else torch.bfloat16
    jq, jkn, jvn = (jnp.asarray(a).astype(jdt) for a in (q, kn, vn))
    tq, tkn, tvn = (torch.from_numpy(a).to(tdt) for a in (q, kn, vn))
    jk = jnp.asarray(k).astype(jdt) / jlayers.QSCALE
    jv = jnp.asarray(v).astype(jdt) / jlayers.QSCALE
    if with_new:
        want = jlayers.decode_attention_two_part(
            jq[:, None], jk, jv, jkn[:, None], jvn[:, None],
            jnp.asarray(lens))[:, 0]
        got = tops.decode_attention(tq, *_t(k, v, lens), tkn, tvn)
    else:
        want = jlayers.decode_attention_xla(jq[:, None], jk, jv,
                                            jnp.asarray(lens))[:, 0]
        got = tops.decode_attention(tq, *_t(k, v, lens))
    # bf16: both round one output to bf16 from f32 sums in other orders
    atol = F32_ATOL if qdt == np.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol)


# ------------------------- deliberate differences from a reference ---------

@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_int8_kv_is_divided_by_qscale_where_pallas_is_not(layout):
    """Deliberate difference: on int8 K/V the Pallas kernels cast to f32
    and do not divide by QSCALE; the serve paths' references (and the
    port) do. So Pallas on int8 K/V equals the port on the same values
    taken as f32 (a factor-16 temperature), not the port on int8."""
    B, H, KV, S, hd, bs = 2, 4, 2, 32, 16, 8
    q, kp_f, vp_f, bt, lens = _case(B, H, KV, S, hd, bs, seed=31)
    rng = np.random.default_rng(32)
    kp = rng.integers(-127, 128, size=kp_f.shape, dtype=np.int8)
    vp = rng.integers(-127, 128, size=kp_f.shape, dtype=np.int8)
    q = q / 8.0           # keep the undivided scores' softmax not one-hot
    if layout == "paged":
        pallas = jops.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lens), interpret=True)
        port = tops.paged_decode_attention(*_t(q, kp, vp, bt, lens))
        as_f32 = tops.paged_decode_attention(
            *_t(q, kp.astype(np.float32), vp.astype(np.float32), bt, lens))
    else:
        k, v = kp[:B * S // bs].reshape(B, S, KV, hd), \
            vp[:B * S // bs].reshape(B, S, KV, hd)
        pallas = jops.decode_attention(
            jnp.asarray(q), _pallas_layout(k), _pallas_layout(v),
            jnp.asarray(lens), interpret=True)
        port = tops.decode_attention(*_t(q, k, v, lens))
        as_f32 = tops.decode_attention(
            *_t(q, k.astype(np.float32), v.astype(np.float32), lens))
    np.testing.assert_allclose(np.asarray(pallas), as_f32.numpy(),
                               rtol=1e-4, atol=1e-3)
    assert np.abs(np.asarray(pallas) - port.numpy()).max() > 1.0


def test_negative_append_slot_is_dropped_where_the_reference_wraps():
    """Deliberate difference: the reference's ``.at[slots].set(mode=
    "drop")`` wraps slot -1 to the arena's last slot; the port drops
    every slot outside [0, NB*BS). The serve paths never form one."""
    NB, BS, KV, hd = 3, 4, 2, 8
    rng = np.random.default_rng(10)
    kp0 = rng.standard_normal((NB, BS, KV, hd), dtype=np.float32)
    vp0 = rng.standard_normal((NB, BS, KV, hd), dtype=np.float32)
    kn = rng.standard_normal((2, KV, hd), dtype=np.float32)
    vn = rng.standard_normal((2, KV, hd), dtype=np.float32)
    slots = np.asarray([5, -1], np.int32)
    jk, _ = jops.update_kv_buffer(jnp.asarray(kp0), jnp.asarray(vp0),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(slots))
    tk, tv = _t(kp0.copy(), vp0.copy())
    tops.update_kv_buffer(tk, tv, *_t(kn, vn, slots))
    ref_flat = np.asarray(jk).reshape(NB * BS, KV, hd)
    np.testing.assert_array_equal(ref_flat[-1], kn[1])          # wrapped
    port_flat = tk.numpy().reshape(NB * BS, KV, hd)
    np.testing.assert_array_equal(port_flat[-1], kp0[-1, -1])   # dropped
    np.testing.assert_array_equal(port_flat[5], kn[0])
    np.testing.assert_array_equal(np.delete(port_flat, 5, axis=0),
                                  np.delete(kp0.reshape(-1, KV, hd), 5,
                                            axis=0))


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_row_with_nothing_to_attend_gives_zero(layout):
    """Deliberate difference: a row of ``lens == 0`` (and no new token)
    is 0 in the port, kernels and plain versions alike. The XLA
    references take a softmax over all -inf and give NaN; the Pallas
    kernels mask with a finite -1e30, so every position weighs the same
    and they give the mean of the row's V."""
    B, H, KV, S, hd, bs = 2, 4, 2, 32, 16, 8
    q, kp, vp, bt, lens = _case(B, H, KV, S, hd, bs, seed=41)
    lens[0] = 0
    G = H // KV
    if layout == "paged":
        port = tops.paged_decode_attention(*_t(q, kp, vp, bt, lens)).numpy()
        xla = jlayers.paged_attention_xla(
            jnp.asarray(q)[:, None], jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lens))[:, 0]
        pallas = jops.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lens), interpret=True)
        v_row0 = vp[bt[0]].reshape(S, KV, hd)
    else:
        k, v = (x[bt].reshape(B, S, KV, hd) for x in (kp, vp))
        port = tops.decode_attention(*_t(q, k, v, lens)).numpy()
        xla = jlayers.decode_attention_xla(
            jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens))[:, 0]
        pallas = jops.decode_attention(
            jnp.asarray(q), _pallas_layout(k), _pallas_layout(v),
            jnp.asarray(lens), interpret=True)
        v_row0 = v[0]
    assert (port[0] == 0).all() and np.isfinite(port).all()
    assert np.isnan(np.asarray(xla)[0]).all()
    mean_v = np.repeat(v_row0.mean(axis=0), G, axis=0)      # [H, hd]
    np.testing.assert_allclose(np.asarray(pallas)[0], mean_v, atol=1e-5)
    np.testing.assert_allclose(port[1], np.asarray(xla)[1], atol=F32_ATOL)

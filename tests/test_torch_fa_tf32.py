"""The numerics of K3a/K3b's f32 kernels (``csrc/flash_attention.cu``:
``fa_fwd_tf32``, ``fa_dq_tf32``, ``fa_dkv_tf32``), emulated on the CPU and
held to the JAX package's attention in f32 on the same inputs.

The kernels run their products on the tensor cores as split TF32: each
operand as a tf32 hi part and a tf32 lo part of the remainder (rounded as
``tf32_tiles.cuh`` rounds them), the product ``a_lo b_hi + a_hi b_lo +
a_hi b_hi``. Emulated here in the kernels' order of sums:

* the scores ``Q K^T`` and ``dO V^T`` (and ``K Q^T``, ``V dO^T`` in dk/dv)
  over the head dim, one sum a tile rounded to f32; where p >= 1/32, dq's
  ``dP`` is summed again as one f32 fma chain over the head dim (the
  plain version's order), since dS = p (dP - delta) cancels there;
* the products over keys (``P V``, ``dS K``) or query rows (``P^T dO``,
  ``dS^T Q``), a fresh sum a tile of ``fwd_tile`` / ``bwd_tile`` keys or
  rows (float64 here) added to the f32 sums, in the forward as
  ``acc c + sum`` with the online softmax's correction ``c``;
* the softmax in f32 as the forward runs it, tile by tile, and the
  backward's ``p = exp(s scale - lse)``, ``dS = p (dP - delta) scale`` with
  delta summed as the wrapper sums it; dk and dv a sum over each KV head's
  query heads in order.

Held to phase 6's f32 rule (``chip_smoke.fa_reading``): each element within
2^-13 of ``|ref| + rms of its head vector + rms / 16`` and a relative
Frobenius error of at most 1e-5, against ``attention_ref`` and
``layers.flash_attention_xla`` (o) and ``jax.vjp`` of the latter (dq, dk,
dv). One tf32 product a product (``a_hi b_hi``) fails it. dq's first rows
hold the rule with the least room (0.92 of it at S 1024, hd 128): there dS
cancels and dq is the f32 rounding of dP and delta, on which two f32
implementations differ (the port's plain version reads 0.66 there against
the same reference). The emulation models the operands' rounding and the
order of the sums, not the tensor core's own sum within a tile (it aligns
its addends and drops low bits): ``chip_smoke.py``'s phase 6 holds the
kernels to the rule on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref
from repro.models import layers as jlayers

torch.set_num_threads(1)

REL, FROB = 2.0 ** -13, 1e-5        # chip_smoke.py: FA_REL, FA_FROB (f32)
LSE_ATOL = 1e-4                     # chip_smoke.py: FA_LSE_ATOL


def fwd_tile(hd):
    """Keys a streamed tile in the forward (``tf_fwd_tile``)."""
    return 32 if hd == 128 else 64


def bwd_tile(hd):
    """Keys (dq) or query rows (dk/dv) a streamed tile (``tf_bwd_tile``)."""
    return {128: 24, 32: 64}.get(hd, 32)


EXACT_P = 1 / 32        # flash_attention.cu: kExactP


def _tf32(t):
    """t rounded to tf32 (10 mantissa bits), to nearest with ties away from
    zero, by masking its bits as the kernels do (tf32_tiles.cuh)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _parts(x, n):
    """x as n tf32 parts, each the rounded remainder of the ones before."""
    out = []
    for _ in range(n):
        out.append(_tf32(x))
        x = x - out[-1]
    return out


def _product(a, b, split):
    """a [..., M, K] @ b [..., K, N], summed exactly (float64): split TF32's
    three tf32 products (``a_lo b_hi + a_hi b_lo + a_hi b_hi``), or with
    ``split`` False one (``a_hi b_hi``)."""
    n = 2 if split else 1
    pa, pb = _parts(a, n), _parts(b, n)
    return sum(pa[i].double() @ pb[j].double()
               for i in range(n) for j in range(n) if i + j < n)


def _fma_chain(a, b):
    """Row by row dot products of a, b [n, K] as one f32 fma chain over K
    in order (``dot_f32``): each step's product exact, the sum rounded to
    f32."""
    acc = torch.zeros(a.shape[0])
    for d in range(a.shape[1]):
        acc = (acc.double() + a[:, d].double() * b[:, d].double()).float()
    return acc


def _causal_drop(i0, n_rows, j0, n_keys, causal):
    """[n_rows, n_keys] bool: key j0 + j is masked for row i0 + i."""
    rows = torch.arange(i0, i0 + n_rows)[:, None]
    keys = torch.arange(j0, j0 + n_keys)[None, :]
    return (keys > rows) if causal else torch.zeros(n_rows, n_keys,
                                                    dtype=torch.bool)


def emulate_fwd(q, k, v, causal, split=True):
    """q [B,H,S,hd], k, v [B,H,Skv,hd] (each query head's KV head) f32 ->
    (o, lse) as ``fa_fwd_tf32`` forms them."""
    B, H, S, hd = q.shape
    Skv, KT, scale = k.shape[2], fwd_tile(hd), hd ** -0.5
    m = torch.full((B, H, S), float("-inf"))
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, hd)
    for j0 in range(0, Skv, KT):
        kj, vj = k[:, :, j0:j0 + KT], v[:, :, j0:j0 + KT]
        s = _product(q, kj.transpose(-1, -2), split).float() * scale
        s = s.masked_fill(_causal_drop(0, S, j0, kj.shape[2], causal),
                          float("-inf"))
        mn = torch.maximum(m, s.amax(-1))
        base = torch.where(mn == float("-inf"), 0.0, mn)
        c = torch.exp(m - base)
        p = torch.exp(s - base[..., None])
        l = l * c + p.sum(-1)
        acc = (acc.double() * c.double()[..., None]
               + _product(p, vj, split)).float()
        m = mn
    d = l.clamp_min(1e-30)
    return acc / d[..., None], m + torch.log(d)


def emulate_bwd(q, k, v, o, lse, do, G, causal, split=True):
    """The inputs as :func:`emulate_fwd`'s, with its o, lse and do [B,H,S,hd]
    -> (dq [B,H,S,hd], dk, dv [B,KV,Skv,hd]) as ``fa_dq_tf32`` and
    ``fa_dkv_tf32`` form them (dk/dv per query head, then the G heads of
    each KV head summed in order, as ``fa_dkv_reduce``)."""
    B, H, S, hd = q.shape
    Skv, KT, scale = k.shape[2], bwd_tile(hd), hd ** -0.5
    # the wrapper's delta: (do * o).sum(-1) in f32, as the plain version
    delta = (do * o).sum(-1)
    dq = torch.zeros(B, H, S, hd)
    for j0 in range(0, Skv, KT):
        kj, vj = k[:, :, j0:j0 + KT], v[:, :, j0:j0 + KT]
        s = _product(q, kj.transpose(-1, -2), split).float()
        dp = _product(do, vj.transpose(-1, -2), split).float()
        p = torch.exp(s * scale - lse[..., None]).masked_fill(
            _causal_drop(0, S, j0, kj.shape[2], causal), 0.0)
        if split:
            b_, h_, i_, j_ = (p >= EXACT_P).nonzero(as_tuple=True)
            dp[b_, h_, i_, j_] = _fma_chain(do[b_, h_, i_],
                                            vj[b_, h_, j_])
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + _product(ds, kj, split).float()
    dk, dv = torch.zeros(B, H, Skv, hd), torch.zeros(B, H, Skv, hd)
    for i0 in range(0, S, KT):
        qi, doi = q[:, :, i0:i0 + KT], do[:, :, i0:i0 + KT]
        n = qi.shape[2]
        st = _product(k, qi.transpose(-1, -2), split).float()
        dpt = _product(v, doi.transpose(-1, -2), split).float()
        pt = torch.exp(st * scale - lse[:, :, None, i0:i0 + n]).masked_fill(
            _causal_drop(i0, n, 0, Skv, causal).T, 0.0)
        dst = pt * (dpt - delta[:, :, None, i0:i0 + n]) * scale
        dv = dv + _product(pt, doi, split).float()
        dk = dk + _product(dst, qi, split).float()

    def per_kv(t):
        t = t.reshape(B, H // G, G, Skv, hd)
        out = t[:, :, 0]
        for g in range(1, G):
            out = out + t[:, :, g]
        return out
    return dq, per_kv(dk), per_kv(dv)


def reading(got, want):
    """phase 6's reading (chip_smoke.fa_reading): the worst ratio of error
    to each element's bound, and the relative Frobenius error."""
    want = torch.from_numpy(np.array(want, np.float32))
    diff = (got - want).abs()
    rms_vec = want.square().mean(dim=-1, keepdim=True).sqrt()
    bound = REL * (want.abs() + rms_vec + want.square().mean().sqrt() / 16)
    return (diff / bound).max().item(), (diff.norm() / want.norm()).item()


@functools.partial(jax.jit, static_argnames="causal")
def _references(q, k, v, do, *, causal):
    """The JAX package's f32 attention on [B,S,*,hd] inputs, one compiled
    call: ``attention_ref``'s o [B,H,S,hd], ``flash_attention_xla``'s o
    [B,S,H,hd] and its ``jax.vjp`` (dq, dk, dv) at ``do``, and lse [B,H,S]
    of the masked scores."""
    S, H, hd = q.shape[1:]
    G = H // k.shape[2]
    o_ref = attention_ref(*(jnp.transpose(a, (0, 2, 1, 3)) for a in
                            (q, k, v)), causal=causal)
    o_xla, vjp = jax.vjp(lambda a, b, c: jlayers.flash_attention_xla(
        a, b, c, causal=causal), q, k, v)
    scores = jnp.einsum("bqhd,bkhd->bhqk", q,
                        jnp.repeat(k, G, axis=2)) * hd ** -0.5
    if causal:
        scores = jnp.where(jnp.tril(jnp.ones((S, S), bool)), scores,
                           -jnp.inf)
    return o_ref, o_xla, vjp(do), jax.nn.logsumexp(scores, axis=-1)


def _run(H, KV, S, hd, causal, *, backward=True, seed=30):
    """Inputs from numpy in the port's layout [B,S,*,hd]; the emulated
    kernels (split and one-product) against the JAX references. Returns
    {split: {output: (worst, frob)}}, and the lse error of the split
    forward."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    qn, kn, vn, don = f(1, S, H, hd), f(1, S, KV, hd), f(1, S, KV, hd), \
        f(1, S, H, hd)
    G = H // KV
    port = lambda a: torch.from_numpy(a).permute(0, 2, 1, 3)  # noqa: E731
    q, do = port(qn), port(don)
    k, v = (port(a).repeat_interleave(G, dim=1) for a in (kn, vn))
    want_ref, want_xla, grads, want_lse = _references(
        *(jnp.asarray(a) for a in (qn, kn, vn, don)), causal=causal)
    to_port = lambda a: np.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    grads = [to_port(g) for g in grads]
    want_lse = np.array(want_lse)
    out, lse_err = {}, None
    for split in (True, False):
        o, lse = emulate_fwd(q, k, v, causal, split)
        r = {"o-attention_ref": reading(o, want_ref),
             "o-flash_attention_xla": reading(o, to_port(want_xla))}
        if split:
            lse_err = (lse - torch.from_numpy(want_lse)).abs().max().item()
        if backward:
            dq, dk, dv = emulate_bwd(q, k, v, o, lse, do, G, causal, split)
            for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       grads):
                r[name] = reading(got, want)
        out[split] = r
    return out, lse_err


CASES = [(hd, S, causal) for hd in (32, 64, 80, 128) for S in (256, 200)
         for causal in (True, False)]


@pytest.mark.parametrize("hd,S,causal", CASES, ids=[
    f"hd{hd}-S{S}-{'causal' if c else 'full'}" for hd, S, c in CASES])
def test_split_tf32_kernels_hold_phase_6s_f32_rule(hd, S, causal):
    """H 4 over KV 2 at every head dim the kernels take, S 256 and a
    ragged 200 (no multiple of a tile), causal and not: o, dq, dk, dv
    within the rule, lse within 1e-4; one tf32 product a product fails the
    rule in every output."""
    got, lse_err = _run(4, 2, S, hd, causal)
    for name, (worst, frob) in got[True].items():
        assert worst <= 1.0 and frob <= FROB, (name, worst, frob)
    assert lse_err <= LSE_ATOL
    for name, (worst, frob) in got[False].items():
        assert worst > 1.0, (name, worst, frob)


@pytest.mark.parametrize("part", ["forward-S2048", "backward-S1024"])
def test_split_tf32_kernels_at_length(part):
    """Longer sums: the forward at H 1, hd 128, S 2048 (2048 keys summed
    through 64 tiles' corrections), the backward at H 2 over KV 1, hd 128,
    S 1024 (dq over 1024 keys, dk/dv over 1024 rows of two heads), both
    causal; split TF32 holds the rule, one tf32 product fails it by far."""
    if part.startswith("forward"):
        got, lse_err = _run(1, 1, 2048, 128, True, backward=False)
        assert lse_err <= LSE_ATOL
    else:
        got, _ = _run(2, 1, 1024, 128, True)
    for name, (worst, frob) in got[True].items():
        assert worst <= 1.0 and frob <= FROB, (name, worst, frob)
    for name, (worst, frob) in got[False].items():
        assert worst > 2.0 and frob > 10 * FROB, (name, worst, frob)

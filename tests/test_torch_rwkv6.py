"""The port's RWKV-6 WKV and rwkv6 model against the JAX package's, on the
CPU, on the same numpy-seeded inputs and bridged weights.

The WKV: ``wkv6_chunked_plain`` against ``wkv6_chunked`` and against the
Pallas ``rwkv6_wkv`` in interpret mode (w in (0.4, 0.9), where the
reference's chunked form is accurate), ``wkv6_backward_plain`` against
``jax.vjp``, the ``ops.rwkv6_wkv`` autograd.Function on CPU tensors, the
decode recurrence and chunked-equals-recurrence, and the reference's
overflow near the clip, which the port does not share. The model (reduced
rwkv6-3b: 2 layers, d_model 128, 4 heads of 32): ``time_mix`` in both
branches and ``channel_mix``, the forward's logits in f32 and bf16, 12
decode steps against the JAX package's carried forward, the prefill step,
``loss_fn``'s gradients and ``make_train_step`` with 1 and 2 microbatches,
and the parameter count. The model tests set the leaves the repo's init
leaves at zero (LoRA B, mixes, bonus) to small random values and the decay
as RWKV-6 initialises it (w in [0.69, 0.9975]): at the repo's init (w =
1/e) a chunk's state decays by e^-64 before the next, and no comparison
could see the carry. Comparisons run in float32 unless a test says
otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.models import rwkv6 as jr
from repro.sharding import rules_for
from repro.train import steps as jsteps
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6_scan as trs
from repro_torch.models import rwkv6 as tr
from repro_torch.models.module import layer_slice
from repro_torch.optim.adamw import leaves
from repro_torch.train import steps as tsteps
from repro_torch.weights import from_jax_params, to_numpy_tree
from test_torch_mamba2 import (
    BF16_REL, LOSS_ATOL, REL, _assert_params_close, _assert_tree_close,
    _batch, _close, _rule_ratio, _Tf32Matmul,
)

torch.set_num_threads(1)

ARCH = "rwkv6-3b"
F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
SEQ = 128                      # two chunks of 64: the carry between them


def _wkv_inputs(seed, b=2, l=128, h=3, d=8, lo=0.4, hi=0.9):
    """r, k, v, do N(0,1); w uniform in (lo, hi); u N(0,1)."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((b, l, h, d), dtype=np.float32)
                   for _ in range(4))
    w = rng.uniform(lo, hi, (b, l, h, d)).astype(np.float32)
    u = rng.standard_normal((h, d), dtype=np.float32)
    return (r, k, v, w, u), do


# -------------------------------------------------------------- the WKV ----

@pytest.mark.parametrize("l,chunk", [(48, 64), (128, 32), (128, 64),
                                     (256, 32), (256, 64)])
def test_wkv6_chunked_plain_matches_jax(l, chunk):
    """Including one chunk covering the sequence (c = L = 48 < 64)."""
    ins, _ = _wkv_inputs(0, l=l)
    oj, sj = jr.wkv6_chunked(*map(jnp.asarray, ins), chunk=chunk)
    ot, st = trs.wkv6_chunked_plain(*map(torch.from_numpy, ins), chunk=chunk)
    assert ot.dtype == torch.float32 and st.shape == sj.shape
    _close(ot, oj, what="o")
    _close(st, sj, what="final state")


def test_wkv_chunk_must_divide_the_sequence():
    """L = 48 with chunk 32: the reference asserts, the port raises."""
    ins, _ = _wkv_inputs(1, l=48)
    with pytest.raises(AssertionError):
        jr.wkv6_chunked(*map(jnp.asarray, ins), chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        trs.wkv6_chunked_plain(*map(torch.from_numpy, ins), chunk=32)


@pytest.mark.parametrize("l,chunk,d", [(128, 64, 64), (64, 32, 32)])
def test_wkv6_chunked_plain_matches_pallas_interpret(l, chunk, d):
    """The Pallas kernel run as ``tests/test_kernels.py`` runs it (in
    interpret mode, at its shapes)."""
    ins, _ = _wkv_inputs(2, l=l, d=d)
    oj, sj = jops.rwkv6_wkv(*map(jnp.asarray, ins), chunk=chunk)
    ot, st = trs.wkv6_chunked_plain(*map(torch.from_numpy, ins), chunk=chunk)
    _close(ot, oj, what="o")
    _close(st, sj, what="final state")


@pytest.mark.parametrize("l,chunk", [(48, 64), (128, 32), (256, 64)])
def test_wkv6_backward_plain_matches_jax_vjp(l, chunk):
    ins, do = _wkv_inputs(3, l=l)
    _, vjp = jax.vjp(lambda *a: jr.wkv6_chunked(*a, chunk=chunk)[0],
                     *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(do))
    got = trs.wkv6_backward_plain(*map(torch.from_numpy, ins),
                                  torch.from_numpy(do), chunk=chunk)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.shape == w.shape
        _close(g, w, what=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_rwkv6_wkv_on_cpu_is_the_plain_version(dtype):
    """On CPU tensors the autograd.Function runs the plain forward and
    backward: o and every gradient equal them exactly, and the final state
    carries no gradient."""
    (r, k, v, w, u), do = _wkv_inputs(4)
    ins = [torch.from_numpy(a).to(dtype) for a in (r, k, v)] + \
        [torch.from_numpy(w), torch.from_numpy(u)]
    do_t = torch.from_numpy(do).to(dtype)
    leaves_ = [t.clone().requires_grad_(True) for t in ins]
    o, s = tops.rwkv6_wkv(*leaves_)
    o.backward(do_t)
    o_p, s_p = trs.wkv6_chunked_plain(*ins)
    assert o.dtype == dtype and not s.requires_grad
    torch.testing.assert_close(o, o_p, rtol=0, atol=0)
    torch.testing.assert_close(s, s_p, rtol=0, atol=0)
    for t, g in zip(leaves_, trs.wkv6_backward_plain(*ins, do_t)):
        torch.testing.assert_close(t.grad, g, rtol=0, atol=0)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks a CUDA tensor meets before a launch (run on CPU tensors:
    they do not depend on the device)."""
    r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(5)[0])
    assert trs._check(r, k, v, w, u)[-1] == 64
    with pytest.raises(ValueError, match="hd up to"):
        big = torch.zeros(1, 64, 2, 65)
        trs._check(big, big, big, big, torch.zeros(2, 65))
    with pytest.raises(ValueError, match=r"u \[H,hd\]"):
        trs._check(r, k, v, w, u[:, :4])
    with pytest.raises(TypeError):
        trs._check(r, k.bfloat16(), v, w, u)
    with pytest.raises(TypeError):
        trs._check(r, k, v, w.double(), u)
    with pytest.raises(ValueError, match="contiguous"):
        trs._check(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, w,
                   u)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        trs._check(*(t[:, :100].contiguous() for t in (r, k, v, w)), u)


@pytest.mark.parametrize("seed", range(4))
def test_wkv6_step_matches_jax_and_chunked_equals_recurrence(seed):
    """``test_models.py``'s property on the port: the chunked WKV equals
    the token-by-token recurrence, whose every step matches the JAX
    package's ``wkv6_step``."""
    rng = np.random.default_rng(100 + seed)
    l, chunk = int(rng.choice([8, 16, 32])), int(rng.choice([4, 8]))
    (r, k, v, w, u), _ = _wkv_inputs(100 + seed, l=l, h=2, d=8, hi=0.95)
    s_j = jnp.zeros((2, 2, 8, 8))
    s_t = torch.zeros(2, 2, 8, 8)
    os_ = []
    for t in range(l):
        oj, s_j = jr.wkv6_step(*(jnp.asarray(a[:, t]) for a in (r, k, v, w)),
                               jnp.asarray(u), s_j)
        ot, s_t = tr.wkv6_step(*(torch.from_numpy(a[:, t])
                                 for a in (r, k, v, w)),
                               torch.from_numpy(u), s_t)
        _close(ot, oj, what=f"o step {t}")
        _close(s_t, s_j, what=f"state step {t}")
        os_.append(ot)
    o_c, s_c = trs.wkv6_chunked_plain(*map(torch.from_numpy, (r, k, v, w, u)),
                                      chunk=chunk)
    np.testing.assert_allclose(o_c.numpy(), torch.stack(os_, 1).numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(s_c.numpy(), s_t.numpy(), atol=2e-4)


@pytest.mark.parametrize("w_value", [0.25, 0.2])
def test_reference_chunked_form_overflows_where_the_port_does_not(w_value):
    """A deliberate difference (ROADMAP Queue 3): over one chunk of 64
    tokens at a constant w = 0.25 the reference's ``wkv6_chunked`` (which
    forms k exp(-cs) and r exp(cp) apart) is off from its own recurrence
    by about 4-5, and at w = 0.2 its exp(-cs) overflows into NaN; the
    port's plain version forms only decays of at most 1 and matches the
    recurrence (``wkv6_step``) to 1e-4 of the outputs' size."""
    rng = np.random.default_rng(0)
    r, k, v = (rng.standard_normal((1, 64, 2, 8), dtype=np.float32)
               for _ in range(3))
    w = np.full((1, 64, 2, 8), w_value, np.float32)
    u = rng.standard_normal((2, 8), dtype=np.float32)
    s = jnp.zeros((1, 2, 8, 8))
    rec = []
    for t in range(64):
        o, s = jr.wkv6_step(*(jnp.asarray(a[:, t]) for a in (r, k, v, w)),
                            jnp.asarray(u), s)
        rec.append(np.asarray(o))
    rec = np.stack(rec, 1)
    ref = np.asarray(jr.wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)))[0])
    port = trs.wkv6_chunked_plain(*map(torch.from_numpy,
                                       (r, k, v, w, u)))[0].numpy()
    if w_value == 0.25:
        assert np.isfinite(ref).all() and np.abs(ref - rec).max() > 1.0
    else:
        assert np.isnan(ref).sum() > 0
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, rec, rtol=0,
                               atol=1e-4 * np.abs(rec).max())


# ------------------------------- the kernels' sub-blocks and products ----

def _subblock_pairs(cs, cp, c):
    """The pairs of the kernels' sub-block form over a chunk of c rows cut
    into blocks of 16: for each T-block a above an S-block b, (rows t,
    rows s, exp(cp_t - ref), exp(ref - cs_s)) with ref = cs at block b's
    last row; cs, cp [..., c, d]. Both factors are at most 1."""
    starts = list(range(0, c, trs.BLOCK))
    rows = [slice(a, min(a + trs.BLOCK, c)) for a in starts]
    out = []
    for a, ta in enumerate(rows):
        for sb in rows[:a]:
            ref = cs[..., sb.stop - 1:sb.stop, :]
            out.append((ta, sb, torch.exp(cp[..., ta, :] - ref),
                        torch.exp(ref - cs[..., sb, :])))
    return rows, out


def _chunk_views(r, k, v, w, c):
    """r, k, v as [b, z, h, c, d] float, and cs, cp of the chunks."""
    b, l, h, d = r.shape
    nc = l // c
    rr, kk, vv = (t.reshape(b, nc, c, h, d).permute(0, 1, 3, 2, 4)
                  .to(torch.float64 if t.dtype == torch.float64
                      else torch.float32) for t in (r, k, v))
    lw = torch.log(w.clamp(trs.CLIP, 1.0)).reshape(b, nc, c, h, d)
    cs = torch.cumsum(lw.permute(0, 1, 3, 2, 4), dim=3)
    cp = torch.cat([torch.zeros_like(cs[..., :1, :]), cs[..., :-1, :]], 3)
    return rr, kk, vv, cs, cp


def _subblock_scores(rr, kk, cs, cp, c, mm=torch.matmul):
    """A [b, z, h, t, s] (s < t) in the sub-block form: each pair as the
    product ``mm`` of r~ = r exp(cp - ref) and k~ = k exp(ref - cs), each
    diagonal block with one exponential per (t, s, channel)."""
    rows, pairs = _subblock_pairs(cs, cp, c)
    blocks = {}
    for ta, sb, ft, fs in pairs:
        blocks[ta.start, sb.start] = mm(rr[..., ta, :] * ft,
                                        (kk[..., sb, :] * fs).transpose(-1,
                                                                        -2))
    strips = []
    for ta in rows:
        n = ta.stop - ta.start
        tri = torch.ones(n, n, dtype=torch.bool).tril(-1)
        e = torch.exp(torch.where(
            tri[:, :, None], cp[..., ta, None, :] - cs[..., None, ta, :],
            float("-inf")))
        diag = torch.einsum("...td,...tsd,...sd->...ts", rr[..., ta, :], e,
                            kk[..., ta, :])
        parts = [blocks[ta.start, sb.start] for sb in rows
                 if sb.start < ta.start] + [diag]
        width = sum(p.shape[-1] for p in parts)
        parts.append(diag.new_zeros(*diag.shape[:-1], c - width))
        strips.append(torch.cat(parts, dim=-1))
    return torch.cat(strips, dim=-2)


def _wkv_subblocks(r, k, v, w, u, split, chunk=64):
    """``wkv6_chunked_plain``'s (o, s_final) in the kernels' form: the
    scores' pairs, A v, the chunk states and the carried state's term as
    products through _Tf32Matmul (split TF32, or one tf32 product), the
    diagonal blocks exact, the rest in f32 as the plain version.
    Differentiable: autograd's backward runs each product's two backward
    products through _Tf32Matmul too, which is the kernels' backward
    (dA k~ and dA^T r~ for the pairs, do v^T, A^T do, the state terms)."""
    b, l, h, d = r.shape
    c = min(chunk, l)
    nc = l // c
    mm = lambda x, y: _Tf32Matmul.apply(x, y, split)      # noqa: E731
    rr, kk, vv, cs, cp = _chunk_views(r, k, v, w, c)
    A = _subblock_scores(rr, kk, cs, cp, c, mm)
    bonus = (rr * u.float()[None, None, :, None, :] * kk).sum(-1)
    o = mm(A, vv) + bonus[..., None] * vv
    kd = kk * torch.exp(cs[..., -1:, :] - cs)
    states = mm(kd.transpose(-1, -2), vv)                  # [b,z,h,d,d]
    g = torch.exp(cs[..., -1, :])                          # [b,z,h,d]
    s = torch.zeros(b, h, d, d)
    prevs = []
    for z in range(nc):
        prevs.append(s)
        s = s * g[:, z, :, :, None] + states[:, z]
    o = o + mm(rr * torch.exp(cp), torch.stack(prevs, dim=1))
    return o.permute(0, 1, 3, 2, 4).reshape(b, l, h, d).to(r.dtype), s


def _rwkv6_wkv_inputs(seed, near_clip, dtype, b=1, l=256, h=4, d=64):
    """chip_smoke.py phase 11's draw on numpy: r, k, v, do N(0, 1) in
    ``dtype``; w = exp(-exp(x)), x uniform in [-6, -1] (RWKV-6's decay
    init), or near the clip log-uniform in [1e-6, 0.2]; u the bonus at a
    middle layer (RWKV-6's init)."""
    rng = np.random.default_rng(seed)
    f = lambda: torch.from_numpy(                          # noqa: E731
        rng.standard_normal((b, l, h, d)).astype(np.float32)).to(dtype)
    r, k, v, do = f(), f(), f(), f()
    x = rng.random((b, l, h, d))
    w = (np.exp(np.log(1e-6) + np.log(0.2 / 1e-6) * x) if near_clip
         else np.exp(-np.exp(-6 + 5 * x)))
    n = np.arange(h * d) / (h * d - 1)
    u = 0.5 * (1 - n) + ((np.arange(h * d) + 1) % 3 - 1) * 0.1
    return (r, k, v, torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy(u.reshape(h, d).astype(np.float32))), do


def _wkv_readings(split, near_clip, dtype):
    """The smoke's rule's worst ratio for each output of the sub-block form
    with emulated products against the plain version (o, s_final; the
    gradients by autograd through the emulated products). dw near the clip
    is read as phase 11 reads it: w dw to 2**-13 of its largest."""
    ins, do = _rwkv6_wkv_inputs(11, near_clip, dtype)
    want = trs.wkv6_chunked_plain(*ins) + trs.wkv6_backward_plain(*ins, do)
    leaves_ = [t.detach().clone().requires_grad_(True) for t in ins]
    o, s = _wkv_subblocks(*leaves_, split=split)
    got = (o.detach(), s.detach()) + torch.autograd.grad(o, leaves_, do)
    names = ("o", "s_final", "dr", "dk", "dv", "dw", "du")
    out = {n: _rule_ratio(g, w_) for n, g, w_ in zip(names, got, want)}
    if near_clip:
        wdw, ref = (got[5] * ins[3]).double(), (want[5] * ins[3]).double()
        out["dw"] = ((wdw - ref).abs().max()
                     / (2.0 ** -13 * ref.abs().max())).item()
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("near_clip", [False, True])
def test_split_tf32_subblocks_hold_the_smokes_rule(near_clip, dtype):
    """The kernels' form of the WKV: the scores' pairs of 16-row blocks as
    products around a reference point and every product (forward, and
    autograd's backward) in split TF32, the diagonal blocks exact: every
    output holds chip_smoke.py phase 11's rule against the f32 plain
    version, at RWKV-6's decays and near the clip, for bf16 and f32 r, k,
    v. This models the operands' rounding only (test_torch_mamba2's
    _product says what it leaves out: the tensor core's own truncating
    sums); phase 11 holds the kernels to the rule on the card."""
    ratios = _wkv_readings(True, near_clip, dtype)
    assert max(ratios.values()) <= 1.0, ratios


def test_one_tf32_product_fails_the_smokes_rule():
    """One tf32 product per product (no lo parts) fails s_final and dw at
    bf16 by more than 4x: why the kernels' products split."""
    ratios = _wkv_readings(False, False, torch.bfloat16)
    assert min(ratios["s_final"], ratios["dw"]) > 4, ratios


def test_subblock_scores_equal_the_per_element_form():
    """The reference-point identity: in f64, the scores of the sub-block
    form (r~ k~^T around cs at each S-block's last row) equal sum_i r k
    exp(cp_t - cs_s) formed per element, including a chunk of 40 rows (no
    multiple of 16)."""
    for l in (128, 40):
        (r, k, v, w, u), _ = _rwkv6_wkv_inputs(3, False, torch.float64, l=l,
                                              h=2, d=16)
        c = min(64, l)
        rr, kk, _, cs, cp = _chunk_views(r, k, v, w.double(), c)
        got = _subblock_scores(rr, kk, cs, cp, c)
        tri = torch.ones(c, c, dtype=torch.bool).tril(-1)
        e = torch.exp(torch.where(tri[:, :, None],
                                  cp[..., :, None, :] - cs[..., None, :, :],
                                  float("-inf")))
        want = torch.einsum("...td,...tsd,...sd->...ts", rr, e, kk)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_subblock_factors_stay_within_one_at_the_clip():
    """At w = 1e-6 (the clip) a 64-row chunk decays by e^-884: the
    reference's exp(-cs) overflows, but every factor of the sub-block form,
    exp(cp_t - ref) and exp(ref - cs_s), lies in [0, 1], and the form's
    outputs are finite."""
    (r, k, v, _, u), _ = _rwkv6_wkv_inputs(4, False, torch.float32, l=64,
                                          h=2, d=16)
    w = torch.full_like(r, 1e-6)
    _, _, _, cs, cp = _chunk_views(r, k, v, w, 64)
    _, pairs = _subblock_pairs(cs, cp, 64)
    assert len(pairs) == 6
    for _, _, ft, fs in pairs:
        for f in (ft, fs):
            assert bool(((f >= 0) & (f <= 1)).all())
    o, s = _wkv_subblocks(r, k, v, w, u, split=True)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())


@pytest.mark.parametrize("shape,blocks,grid,states,du_part", [
    ((1, 4096, 40, 64), 4, (64, 40, 1), (1, 40, 64, 64, 64), (40, 1, 64, 64)),
    ((1, 48, 40, 64), 3, (1, 40, 1), (1, 40, 1, 64, 64), (40, 1, 1, 64)),
    ((1, 40, 40, 64), 3, (1, 40, 1), (1, 40, 1, 64, 64), (40, 1, 1, 64)),
    ((4, 256, 40, 64), 4, (4, 40, 4), (4, 40, 4, 64, 64), (40, 4, 4, 64)),
    ((2, 128, 3, 8), 4, (2, 3, 2), (2, 3, 2, 8, 8), (3, 2, 2, 8))])
def test_plan_cuts_the_chunk_and_sizes_the_scratch(shape, blocks, grid,
                                                   states, du_part):
    """One CTA per (chunk, head, row); a chunk of c rows is ceil(c / 16)
    sub-blocks (40 rows: 3, the last of 8); the scratch: states
    [B,H,nc,hd,hd], decays [B,H,nc,hd], cs [B,L,H,hd], du's partials
    [H,B,nc,hd]."""
    pl = trs.plan(*shape)
    B, L, H, hd = shape
    assert pl.chunk == min(64, L)
    assert (pl.blocks, pl.grid, pl.states, pl.du_part) == (blocks, grid,
                                                          states, du_part)
    assert pl.decays == states[:-1] and pl.cs == shape
    with pytest.raises(ValueError, match="multiple of the chunk"):
        trs.plan(1, 100, 2, 8)


# ------------------------------------------------------------ the model ----

def rwkv6_decay_base(n_layers: int, d: int) -> np.ndarray:
    """[L, D] decay_base as RWKV-6 initialises its ``time_decay`` (RWKV-LM,
    v6): channel n of layer i at -6 + 5 (n / (D - 1))^(0.7 + 1.3 i / (L -
    1)), spread over [-6, -1], so w = exp(-exp(.)) lies in [0.69, 0.9975]
    and a state carries across many chunks."""
    ratio = np.arange(n_layers) / max(n_layers - 1, 1)
    n = np.arange(d) / (d - 1)
    return (-6 + 5 * n[None, :] ** (0.7 + 1.3 * ratio[:, None])).astype(
        np.float32)


def _trained(np_params, seed):
    """The repo's zero-initialised leaves (mixes, LoRA B, bonus) as small
    random values and the decay as RWKV-6 initialises it, in place."""
    rng = np.random.default_rng(seed)
    t, m = np_params["blocks"]["tmix"], np_params["blocks"]["cmix"]
    for tree, names in ((t, ("mix_base", "mix_lora_B", "mix_mu",
                             "decay_lora_B", "bonus")),
                        (m, ("mu_k", "mu_r"))):
        for n in names:
            tree[n] = (0.1 * rng.standard_normal(tree[n].shape)).astype(
                np.float32)
    t["decay_base"] = rwkv6_decay_base(*t["decay_base"].shape)
    return np_params


def _setup(mesh11, seed=6, **overrides):
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **overrides)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **overrides)
    params, _ = jr.init(jax.random.PRNGKey(seed), jcfg)
    np_params = _trained(jax.tree_util.tree_map(np.asarray, params), seed)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jcfg, cfg, params, np_params, rules_for(jcfg, mesh11)


def _tokens(cfg, seed, rows=2, seq=SEQ):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(rows, seq)).astype(np.int32)


def test_param_count_matches_config():
    cfg = get_config(ARCH).reduced()
    params = tr.init(cfg, seed=0, device="cpu")
    assert sum(p.numel() for p in leaves(params)) == cfg.param_count()
    jparams, _ = jr.init(jax.random.PRNGKey(0), jax_config(ARCH).reduced())
    assert jax.tree_util.tree_structure(jparams) == \
        jax.tree_util.tree_structure(to_numpy_tree(params))


def _mix_inputs(cfg, compute, decode, seed):
    rng = np.random.default_rng(seed)
    S = 1 if decode else SEQ
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    shift = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    state = rng.standard_normal((2, cfg.n_heads, cfg.hd, cfg.hd),
                                dtype=np.float32)
    jdt, tdt = jnp.dtype(compute), getattr(torch, compute)
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(shift).astype(jdt),
             jnp.asarray(state)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(shift).to(tdt),
             torch.from_numpy(state)))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode", [False, True])
def test_time_mix_matches_jax(compute, decode, mesh11):
    """One time mix (layer 1 of the bridged stack): the chunked branch over
    two chunks from a zero state (a token shift from a given last input),
    or one decode step from a random WKV state."""
    jcfg, cfg, params, np_params, rules = _setup(
        mesh11, compute_dtype=compute, kv_cache_dtype=compute)
    tparams = from_jax_params(np_params, cfg, device="cpu")
    jp = jax.tree_util.tree_map(lambda a: a[1], params["blocks"])
    tp = layer_slice(tparams["blocks"], 1)
    (xj, shj, stj), (xt, sht, stt) = _mix_inputs(cfg, compute, decode, 7)
    with mesh11:
        oj, s1j, wj = jax.jit(lambda p, x, sh, st: jr.time_mix(
            p, jcfg, rules, x, shift_state=sh,
            wkv_state=st if decode else None, decode=decode))(jp, xj, shj,
                                                             stj)
    with torch.no_grad():
        ot, s1t, wt = tr.time_mix(tp, cfg, xt, shift_state=sht,
                                  wkv_state=stt if decode else None,
                                  decode=decode)
    rel = REL if compute == "float32" else BF16_REL
    assert ot.dtype == getattr(torch, compute) and wt.dtype == torch.float32
    _close(ot, np.asarray(oj.astype(jnp.float32)), rel, "out")
    _close(s1t, np.asarray(s1j.astype(jnp.float32)), rel, "shift")
    _close(wt, wj, rel, "wkv state")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(compute, mesh11):
    jcfg, cfg, params, np_params, rules = _setup(
        mesh11, compute_dtype=compute, kv_cache_dtype=compute)
    tparams = from_jax_params(np_params, cfg, device="cpu")
    jp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    tp = layer_slice(tparams["blocks"], 0)
    (xj, shj, _), (xt, sht, _) = _mix_inputs(cfg, compute, False, 8)
    with mesh11:
        oj, s2j = jax.jit(lambda p, x, sh: jr.channel_mix(
            p, jcfg, rules, x, shift_state=sh))(jp, xj, shj)
    with torch.no_grad():
        ot, s2t = tr.channel_mix(tp, cfg, xt, shift_state=sht)
    rel = REL if compute == "float32" else BF16_REL
    _close(ot, np.asarray(oj.astype(jnp.float32)), rel, "out")
    _close(s2t, np.asarray(s2j.astype(jnp.float32)), rel, "shift")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_logits_match_jax(compute, mesh11):
    jcfg, cfg, params, np_params, rules = _setup(mesh11,
                                                 compute_dtype=compute)
    toks = _tokens(cfg, 8)
    with mesh11:
        lj, _ = jax.jit(lambda p, t: jr.forward(p, jcfg, rules, t))(
            params, jnp.asarray(toks))
    with torch.no_grad():
        lt, cache = tr.forward(from_jax_params(np_params, cfg, device="cpu"),
                               cfg, torch.from_numpy(toks))
    assert cache is None and lt.dtype == torch.float32
    _close(lt, lj, REL if compute == "float32" else BF16_REL, "logits")


def test_twelve_decode_steps_match_jax_carried_forward(mesh11):
    """12 greedy-fed decode steps over the carried cache (WKV state and
    token shifts), logits and every cache leaf after each step. The JAX
    cache starts with bf16 shifts (its default) and returns them in the
    compute dtype; the port holds them in the compute dtype throughout."""
    jcfg, cfg, params, np_params, rules = _setup(mesh11, **F32)
    tparams = from_jax_params(np_params, cfg, device="cpu")
    B, MAX = 2, 16
    jcache = jr.init_cache(jcfg, B, MAX)
    tcache = tr.init_cache(cfg, B, MAX, device="cpu")
    step_j = jax.jit(lambda p, c, t, cl: jr.forward(
        p, jcfg, rules, t, cache=c, cache_len=cl))
    tok = _tokens(cfg, 9, rows=B, seq=1)
    cl = np.array([0, 3], np.int32)
    for i in range(12):
        with mesh11:
            lj, jcache = step_j(params, jcache, jnp.asarray(tok),
                                jnp.asarray(cl))
        with torch.no_grad():
            lt, tcache = tr.forward(tparams, cfg, torch.from_numpy(tok),
                                    cache=tcache,
                                    cache_len=torch.from_numpy(cl))
        _close(lt, lj, what=f"logits step {i}")
        for name in ("wkv", "shift1", "shift2"):
            assert tcache[name].dtype == torch.float32
            _close(tcache[name], jcache[name], what=f"{name} step {i}")
        tok = np.asarray(lj).argmax(-1).astype(np.int32)
        cl = cl + 1


def test_prefill_step_matches_jax(mesh11):
    jcfg, cfg, params, np_params, rules = _setup(mesh11, **F32)
    toks = _tokens(cfg, 10)
    with mesh11:
        jl, jn = jax.jit(jsteps.make_prefill_step(jcfg, rules))(
            params, {"tokens": jnp.asarray(toks)})
    tl, tn = tsteps.make_prefill_step(cfg)(
        from_jax_params(np_params, cfg, device="cpu"),
        {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tn.dtype == torch.int32
    _close(tl, jl, what="logits")
    assert tn.tolist() == np.asarray(jn).tolist()


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(remat, mesh11):
    """With remat "full" the port checkpoints each block (the reference's
    ``jax.checkpoint(body)``); the gradients are the same."""
    jcfg, cfg, params, np_params, rules = _setup(mesh11, remat=remat, **F32)
    jb, tb = _batch(cfg, 11, seq=SEQ)
    with mesh11:
        (jloss, jaux), jgrads = jax.jit(lambda p, b: jax.value_and_grad(
            jsteps.loss_fn, has_aux=True)(p, jcfg, rules, b,
                                          JTrainConfig()))(params, jb)
    tparams = from_jax_params(np_params, cfg, device="cpu", master=True)
    for p in leaves(tparams):
        p.requires_grad_(True)
    tloss, taux = tsteps.loss_fn(tparams, cfg, tb, TrainConfig())
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=LOSS_ATOL)
    np.testing.assert_allclose(taux["nll"].item(), float(jaux["nll"]),
                               atol=LOSS_ATOL)
    tgrads = jax.tree_util.tree_map(lambda p: p.grad, tparams)
    _assert_tree_close(to_numpy_tree(tgrads), jgrads, what="grads")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches, mesh11):
    jcfg, cfg, params, np_params, rules = _setup(mesh11, **F32)
    jb, tb = _batch(cfg, 12, seq=SEQ)
    jts, jopt = jsteps.make_train_step(jcfg, rules, JTrainConfig(
        microbatches=microbatches))
    with mesh11:
        jp, jstate, jmet = jax.jit(jts)(params, jopt.init(params), jb)
    ts, opt = tsteps.make_train_step(cfg, TrainConfig(
        microbatches=microbatches))
    tparams = from_jax_params(np_params, cfg, device="cpu", master=True)
    tstate = opt.init(tparams)
    tp, _, tmet = ts(tparams, tstate, tb)
    for name in ("loss", "grad_norm", "nll"):
        np.testing.assert_allclose(tmet[name].item(), float(jmet[name]),
                                   atol=LOSS_ATOL, rtol=1e-5, err_msg=name)
    _assert_params_close(to_numpy_tree(tp), jp, jstate.m)
    _assert_tree_close(to_numpy_tree(tstate.m), jstate.m, what="m")
    _assert_tree_close(to_numpy_tree(tstate.v), jstate.v, what="v")


def test_train_step_takes_the_wkv_it_is_given():
    """``Kernels.wkv`` reaches every block of the no-cache forward (the smoke's
    kernels-vs-plain comparison relies on it), once per block and
    microbatch, twice under remat."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), remat="full",
                              **F32)
    calls = []

    def counting(*a):
        calls.append(a[0].shape)
        return trs.wkv6_chunked_plain(*a)
    _, tb = _batch(cfg, 13)
    params = tr.init(cfg, seed=0, device="cpu", master=True)
    ts, opt = tsteps.make_train_step(cfg, TrainConfig(microbatches=2),
                                     tops.Kernels(wkv=counting))
    ts(params, opt.init(params), tb)
    assert len(calls) == 2 * cfg.n_layers * 2
    assert calls[0] == (2, 64, cfg.n_heads, cfg.hd)


def test_registry_and_steps_take_rwkv6_and_refuse_paged_decode():
    from repro_torch.models.registry import get_api
    cfg = get_config(ARCH).reduced()
    assert get_api(cfg).forward is tr.forward
    with pytest.raises(ValueError, match="not block-addressable"):
        tsteps.make_paged_serve_step(cfg)
    with pytest.raises(ValueError, match="no embeds"):
        tr.forward(tr.init(cfg, seed=0, device="cpu"), cfg,
                   torch.zeros((1, 4), dtype=torch.int64),
                   embeds=torch.zeros((1, 2, cfg.d_model)))

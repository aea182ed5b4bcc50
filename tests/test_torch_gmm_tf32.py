"""The numerics of K6/K6b's f32 routes, emulated on the CPU at the expert
products' widths (d_model 2048 -> d_ff 1408, the depth K 2048) with fewer
rows: a decode step's tiles of 4 rows over 4 experts, training's tiles of
64 rows (512 on the card) over 2.

* Training's tiles and every dw run split TF32 on the card's tensor cores
  (``csrc/moe_gmm.cu``: ``gmm_tf32``). Emulated here: each operand as a
  tf32 hi part and a tf32 lo part of the remainder (rounded as the kernels
  round), each depth step of 8 summed fresh (in float64 here) and added to
  a float32 accumulator, step after step, as ``mma3`` adds its fresh sum.
  Against the plain version, the three-part product ``a_hi b_hi + a_hi
  b_lo + a_lo b_hi`` holds phase 14's f32 rule (each element within 2^-13
  of ``|ref| + rms of its row + rms / 16``, and a relative Frobenius error
  of at most 1e-5), and one tf32 product per product fails it.
* A decode step's forward and dx (at most 16 rows a tile) stream the
  weight and multiply in exact f32 (``gmm_stream``): warp w sums depths
  [4 w, 4 w + 4) of each 32-deep stage with fmaf, and the eight warps' sums
  are added in order. That order, emulated, holds the rule too.

The emulation models the operands' rounding and the order of the sums,
not the tensor core's own sum of a step (it aligns its addends and drops
low bits): chip_smoke.py's phase 14 holds the kernels to the rule on the
card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_gmm as mg

K, N = 2048, 1408                   # d_model -> d_ff of moonshot-v1-16b-a3b
REL, FROB = 2.0 ** -13, 1e-5        # chip_smoke.py: FA_REL, GMM_F32_FROB
SHAPES = {"decode": (4, 4), "train": (2, 64)}     # (experts, tile rows)


def _inputs(route):
    """phase 14's draw on numpy: x, dy N(0, 1), w N(0, 1) K^-1/2, one tile
    an expert in a shuffled order."""
    E, tm = SHAPES[route]
    rng = np.random.default_rng(29)
    f = lambda *s: torch.from_numpy(                      # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x, w, dy = f(E * tm, K), f(E, K, N) * K ** -0.5, f(E * tm, N)
    te = torch.from_numpy(rng.permutation(E).astype(np.int32))
    return x, w, dy, te, tm


def _tf32(t):
    """t rounded to tf32 (10 mantissa bits), to nearest with ties away from
    zero, by masking its bits as the kernels do (tf32_tiles.cuh)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mma_product(a, b, split):
    """a [t, M, D] @ b [t, D, N] as the tile kernel forms it: per depth
    step of 8 a fresh sum of the tf32 products (a_hi b_hi, and with
    ``split`` a_hi b_lo + a_lo b_hi), added in float32 to the running
    sum."""
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
    for k in range(0, a.shape[2], 8):
        ak, bk = a[:, :, k:k + 8], b[:, k:k + 8]
        ah, bh = _tf32(ak), _tf32(bk)
        step = ah.double() @ bh.double()
        if split:
            al, bl = _tf32(ak - ah), _tf32(bk - bh)
            step = step + ah.double() @ bl.double() + al.double() @ bh.double()
        acc = acc + step.float()
    return acc


def _stream_product(a, b):
    """a [t, R, K] @ b [t, K, N] as the decode kernel forms it: warp w of 8
    takes depths 32 s + 4 w + kk (kk = 0..3 in order, stage s after stage
    s), each an fmaf; then the warps' sums added in warp order."""
    t, R, D = a.shape
    acc = torch.zeros(8, t, R, b.shape[2])
    for s in range(0, D, 32):
        for kk in range(4):
            idx = torch.arange(8) * 4 + s + kk
            prod = (a[:, :, idx].permute(2, 0, 1)[..., None].double()
                    * b[:, idx].permute(1, 0, 2)[:, :, None, :].double())
            acc = (acc.double() + prod).float()     # one rounding: fmaf
    out = acc[0]
    for w in range(1, 8):
        out = out + acc[w]
    return out


def _routes(x, w, dy, te, tm, product):
    """(out, dx, dw) of the table through ``product`` over each tile, dw
    summed over each expert's tiles in table order."""
    nt, E = te.shape[0], w.shape[0]
    ws = w[te.long()]
    xt, dyt = x.view(nt, tm, K), dy.view(nt, tm, N)
    out = product(xt, ws).reshape(-1, N)
    dx = product(dyt, ws.transpose(1, 2).contiguous()).reshape(-1, K)
    part = product(xt.transpose(1, 2).contiguous(), dyt)
    dw = torch.zeros(E, K, N).index_add_(0, te.long(), part)
    return {"out": out, "dx": dx, "dw": dw}


def _plain(x, w, dy, te, tm):
    dx, dw = mg.gmm_backward_plain(x, w, te, tm, dy)
    return {"out": mg.gmm_plain(x, w, te, tm), "dx": dx, "dw": dw}


def _reading(got, want):
    """phase 14's reading (chip_smoke.fa_reading): the worst ratio of
    error to each element's bound, and the relative Frobenius error."""
    diff = (got - want).abs()
    rms_vec = want.square().mean(dim=-1, keepdim=True).sqrt()
    bound = REL * (want.abs() + rms_vec + want.square().mean().sqrt() / 16)
    return (diff / bound).max().item(), (diff.norm() / want.norm()).item()


@pytest.fixture(scope="module")
def tf32_readings():
    """route -> split -> output -> (worst, frob), for the outputs the
    tile kernel computes at that route (training: all three; decode: dw)."""
    out = {}
    for route in SHAPES:
        ins = _inputs(route)
        want = _plain(*ins)
        out[route] = {}
        for split in (True, False):
            got = _routes(*ins, lambda a, b: _mma_product(a, b, split))
            names = ("out", "dx", "dw") if route == "train" else ("dw",)
            out[route][split] = {n: _reading(got[n], want[n])
                                 for n in names}
    return out


CASES = ["train-out", "train-dx", "train-dw", "decode-dw"]


@pytest.mark.parametrize("case", CASES)
def test_split_tf32_products_hold_phase_14s_f32_rule(tf32_readings, case):
    route, name = case.split("-")
    worst, frob = tf32_readings[route][True][name]
    assert worst <= 1.0 and frob <= FROB, (worst, frob)


@pytest.mark.parametrize("case", CASES)
def test_one_tf32_product_fails_phase_14s_f32_rule(tf32_readings, case):
    """Why the tiles split: one tf32 product per product leaves about 11 of
    f32's 24 bits, and fails both readings by far."""
    route, name = case.split("-")
    worst, frob = tf32_readings[route][False][name]
    assert worst > 2.0 and frob > 10 * FROB, (worst, frob)


@pytest.mark.parametrize("name", ["out", "dx"])
def test_decode_stream_order_holds_phase_14s_f32_rule(name):
    """The decode kernel's exact f32 products, summed in its order (eight
    warps' partial sums added in order), hold the rule to far within it."""
    x, w, dy, te, tm = _inputs("decode")
    ws = w[te.long()]
    nt = te.shape[0]
    if name == "out":
        got = _stream_product(x.view(nt, tm, K), ws).reshape(-1, N)
    else:
        got = _stream_product(dy.view(nt, tm, N),
                              ws.transpose(1, 2).contiguous()).reshape(-1, K)
    worst, frob = _reading(got, _plain(x, w, dy, te, tm)[name])
    assert worst <= 0.1 and frob <= FROB / 10, (worst, frob)

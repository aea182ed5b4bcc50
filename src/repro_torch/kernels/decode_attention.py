"""Flash-decode: one query token per row against a KV cache, in two
layouts, each a wrapper around a hand-written CUDA kernel beside its plain
PyTorch version.

* :func:`paged_decode_attention` (K1) reads the genesys.pagedkv block
  arena through per-sequence block tables. Its kernel
  (``csrc/paged_decode.cu`` over ``csrc/decode_common.cuh``) replaces the
  Pallas ``paged_decode_attention`` / ``_paged_kernel`` of
  ``src/repro/kernels/decode_attention.py``;
  :func:`paged_decode_attention_plain` is the gather-then-masked-softmax
  of the JAX package's ``models.layers.paged_attention_xla``.
* :func:`decode_attention` (K2) reads one layer of the carried dense
  cache ``[B,S,KV,hd]`` and can fold in the step's new token without
  writing it first (the carried-cache branch's two-part softmax). Its
  kernel (``csrc/dense_decode.cu``, same header) replaces the Pallas
  ``decode_attention`` / ``_kernel``; :func:`decode_attention_plain` is
  the JAX package's ``decode_attention_xla`` without the new token and
  ``decode_attention_two_part`` with it.

Bound on an H100: bytes. A call reads each valid K/V position once,
``2 * sum(lens) * KV * hd * itemsize`` bytes, for about ``4 * hd * G``
FLOPs per position and KV head (G = H / KV query heads share it): some G
FLOPs per byte in bf16, far below the ~295 at which the card turns
compute-bound. The kernels therefore load each page (K2: each 64-token
stretch of a row) once per (row, KV head) for all G heads, in tiles of
64 tokens whose 16-byte loads are all in flight together, and with bf16
queries at head_dim 128 do both products on the tensor cores
(``mma.sync``, the G heads padded to 16 rows; f32 models take a CUDA-core
variant); stop at the row's length instead of walking the whole table or
cache; and split a row into pieces (``PAGES_PER_SPLIT`` pages,
``TOKENS_PER_SPLIT`` positions) so that long rows spread over the SMs,
with a grid sized to the card (``CTAS_PER_SM``) whose CTAs stride over
the splits. A second small kernel merges the splits by log-sum-exp, and
K2's new token with them.

Precision: the kernels accumulate in f32; their tensor-core path rounds
the unnormalised softmax weights to bf16 before the PV product, the plain
versions (like the references) the normalised ones (two-part: the weights
normalised by the running max, not yet by the sum). In bf16 the two land
about one bf16 ulp apart (``chip_smoke.py`` holds them to two ulps of the
largest |output|); in f32 to 1e-4.

A row with nothing to attend (``lens == 0`` and no new token) gives 0 in
both kernels and both plain versions; the XLA references give NaN there.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

# static symmetric int8 KV quantization scale (repro.models.layers.QSCALE)
QSCALE = 16.0
# pages in one split of a row: 8 pages of 16 tokens
PAGES_PER_SPLIT = 8
# cache positions in one split of a dense row (a multiple of 64)
TOKENS_PER_SPLIT = 128
# split-kernel CTAs to aim for per SM; CTAs stride over a row's splits
CTAS_PER_SM = 8

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lens):
    """q [B,H,hd]; k_pages/v_pages [NB,BS,KV,hd] (int8 pages are
    dequantised by 1/QSCALE in q's dtype); block_tables [B,MB] (rows
    padded with the null block, masked by ``lens``); lens [B] valid
    positions (a row of 0 gives 0). Returns [B,H,hd] in q's dtype; scores
    are scaled by hd ** -0.5.

    Gathers each row's pages into [B, MB*BS, KV, hd] and runs the masked
    decode softmax with f32 scores, as ``paged_attention_xla`` and
    ``decode_attention_xla`` do in the JAX package."""
    B, H, hd = q.shape
    NB, BS, KV, _ = k_pages.shape
    MB = block_tables.shape[1]
    G = H // KV
    scale = hd ** -0.5
    idx = block_tables.long()
    kd = k_pages[idx].reshape(B, MB * BS, KV, hd)
    vd = v_pages[idx].reshape(B, MB * BS, KV, hd)
    if k_pages.dtype == torch.int8:
        kd = kd.to(q.dtype) / QSCALE
        vd = vd.to(q.dtype) / QSCALE
    qr = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qr.float(), kd.float()) * scale
    pos = torch.arange(MB * BS, device=q.device)
    mask = pos[None, :] < lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = _nothing_to_attend_is_zero(torch.softmax(s, dim=-1), lens)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(vd.dtype).float(), vd.float())
    return o.reshape(B, H, hd).to(q.dtype)


def _nothing_to_attend_is_zero(p, lens):
    """Softmax weights [B,KV,G,S] with the rows of ``lens <= 0`` (all
    masked, so NaN) set to 0, as the kernels' merge gives them."""
    return p.masked_fill((lens <= 0)[:, None, None, None], 0.0)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lens):
    """Paged decode attention, same contract as
    :func:`paged_decode_attention_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise on what it does not
    take. ``paged_decode_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, lens)
    return _launch(q, k_pages, v_pages, block_tables, lens)


paged_decode_attention.launches = 0


def decode_attention_plain(q, k, v, lens, k_new=None, v_new=None):
    """q [B,H,hd]; k/v [B,S,KV,hd], one layer of the carried cache (int8
    is dequantised by 1/QSCALE in q's dtype); lens [B] cached positions to
    attend (from S on, all S are). Optionally the step's new token
    k_new/v_new [B,KV,hd] in q's dtype, attended beside the cache and not
    quantised. Returns [B,H,hd] in q's dtype; scores are scaled by
    hd ** -0.5 and taken in f32.

    Without the new token this is ``decode_attention_xla`` of the JAX
    package (a row of ``lens == 0`` gives 0 here, NaN there); with it,
    ``decode_attention_two_part``, including its cast of the weights,
    normalised by the running max only, to the cache's dtype before the
    PV product."""
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    if k.dtype == torch.int8:
        k = k.to(q.dtype) / QSCALE
        v = v.to(q.dtype) / QSCALE
    qr = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qr, k.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    if k_new is None:
        p = _nothing_to_attend_is_zero(torch.softmax(s, dim=-1), lens)
        o = torch.einsum("bkgs,bskh->bkgh", p.to(v.dtype).float(), v.float())
    else:
        s_new = torch.einsum("bkgh,bkh->bkg", qr, k_new.float()) * scale
        m = torch.maximum(s.amax(dim=-1), s_new)
        p_old = torch.exp(s - m[..., None])
        p_new = torch.exp(s_new - m)
        o = torch.einsum("bkgs,bskh->bkgh", p_old.to(v.dtype).float(),
                         v.float())
        o = o + p_new[..., None] * v_new.float()[:, :, None, :]
        o = o / (p_old.sum(dim=-1) + p_new)[..., None]
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention(q, k, v, lens, k_new=None, v_new=None):
    """Dense-cache decode attention, same contract as
    :func:`decode_attention_plain`. CPU tensors take the plain version;
    CUDA tensors launch the kernel, or raise on what it does not take.
    ``decode_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lens, k_new, v_new)
    return _launch_dense(q, k, v, lens, k_new, v_new)


decode_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, KV, k, v, what, tensors):
    """What both kernels take: H a multiple of KV with at most 16 heads
    per KV head, hd a multiple of 16 up to 256, f32 or bf16 queries, K/V
    in q's dtype or int8, every input on q's device and contiguous."""
    _, H, hd = q.shape
    if H % KV or H // KV > 16 or hd % 16 or hd > 256:
        raise ValueError(f"kernel takes H % KV == 0, H/KV <= 16, hd a "
                         f"multiple of 16 up to 256; got H={H} KV={KV} "
                         f"hd={hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in (q.dtype, torch.int8) or v.dtype != k.dtype:
        raise TypeError(f"{what} must be {q.dtype} or int8, got "
                        f"{k.dtype}/{v.dtype}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def _buffers(q, KV, NS):
    """The output, the split partials (o [B,H,NS,hd], (m, l) [B,H,NS,2]
    f32) and the split kernels' grid width: CTAS_PER_SM CTAs per SM over
    the B*KV (row, KV head) pairs, at most NS."""
    B, H, hd = q.shape
    grid_x = min(NS, -(-CTAS_PER_SM * _sm_count(q.device) // (B * KV)))
    part_o = torch.empty((B, H, NS, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, NS, 2), dtype=torch.float32, device=q.device)
    return torch.empty_like(q), part_o, part_ml, grid_x


def _launch(q, k_pages, v_pages, block_tables, lens):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q [B,H,hd] and pages [NB,BS,KV,hd] expected, got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, hd = q.shape
    NB, BS, KV, hd_k = k_pages.shape
    if hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or lens.shape != (B,):
        raise ValueError(f"block_tables [B,MB] and lens [B] expected for "
                         f"B={B}, got {tuple(block_tables.shape)} and "
                         f"{tuple(lens.shape)}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("block_tables and lens must be int32")
    _check(q, KV, k_pages, v_pages, "pages",
           (q, k_pages, v_pages, block_tables, lens))
    MB = block_tables.shape[1]
    NS = -(-MB // PAGES_PER_SPLIT)
    out, part_o, part_ml, grid_x = _buffers(q, KV, NS)
    kv_scale = 1.0 / QSCALE if k_pages.dtype == torch.int8 else 1.0
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), B, H, KV, hd, BS, MB,
            PAGES_PER_SPLIT, NS, grid_x, hd ** -0.5, kv_scale,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def _launch_dense(q, k, v, lens, k_new, v_new):
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q [B,H,hd] and cache [B,S,KV,hd] expected, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    if k.shape != (B, S, KV, hd) or v.shape != k.shape \
            or lens.shape != (B,):
        raise ValueError(f"cache {tuple(k.shape)} / {tuple(v.shape)} and "
                         f"lens {tuple(lens.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if lens.dtype != torch.int32:
        raise TypeError(f"lens must be int32, got {lens.dtype}")
    if B * S >= 2 ** 31:
        raise ValueError(f"B*S = {B * S} positions do not fit int32")
    tensors = [q, k, v, lens]
    if (k_new is None) != (v_new is None):
        raise ValueError("give both k_new and v_new, or neither")
    if k_new is not None:
        if k_new.shape != (B, KV, hd) or v_new.shape != k_new.shape:
            raise ValueError(f"k_new/v_new [B,KV,hd] expected, got "
                             f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
        if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
            raise TypeError(f"k_new/v_new must be {q.dtype}, got "
                            f"{k_new.dtype}/{v_new.dtype}")
        tensors += [k_new, v_new]
    _check(q, KV, k, v, "cache", tensors)
    NS = -(-S // TOKENS_PER_SPLIT)
    out, part_o, part_ml, grid_x = _buffers(q, KV, NS)
    kv_scale = 1.0 / QSCALE if k.dtype == torch.int8 else 1.0
    new = (0, 0) if k_new is None else (k_new.data_ptr(), v_new.data_ptr())
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dense_decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *new, lens.data_ptr(),
            out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), B, H, KV,
            hd, S, TOKENS_PER_SPLIT, NS, grid_x, hd ** -0.5, kv_scale,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out

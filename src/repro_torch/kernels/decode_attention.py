"""Paged split-KV flash-decode: one query token per sequence against the
genesys.pagedkv block arena, read through per-sequence block tables.

:func:`paged_decode_attention` is the wrapper around the hand-written CUDA
kernel (``csrc/paged_decode.cu``: ``paged_decode_split`` and
``paged_decode_merge``). It replaces the Pallas kernel
``paged_decode_attention`` / ``_paged_kernel`` of
``src/repro/kernels/decode_attention.py``.
:func:`paged_decode_attention_plain` is its plain PyTorch version: the
gather-then-masked-softmax computation of the JAX package's
``models.layers.paged_attention_xla``, which the kernel must match.

Bound on an H100: bytes. A call reads each valid K/V position once,
``2 * sum(lens) * KV * hd * itemsize`` bytes, for about ``4 * hd * G``
FLOPs per position and KV head (G = H / KV query heads share it): some G
FLOPs per byte in bf16, far below the ~295 at which the card turns
compute-bound. The kernel therefore loads each page once per (sequence,
KV head) for all G heads, in tiles of 64 tokens whose 16-byte loads are
all in flight together, and with bf16 queries at head_dim 128 does both
products on the tensor cores (``mma.sync``, the G heads padded to 16
rows; f32 models take a CUDA-core variant); stops at ``ceil(lens / BS)``
pages instead of
walking the whole table; and splits a row into pieces of
``PAGES_PER_SPLIT`` pages so that long rows spread over the SMs, with a
grid sized to the card (``CTAS_PER_SM``) whose CTAs stride over the
splits. A second small kernel merges the splits by log-sum-exp.

Precision: the kernel accumulates in f32; its tensor-core path rounds the
unnormalised softmax weights to bf16 before the PV product, the plain
version (like the reference) the normalised ones. In bf16 the two land
about one bf16 ulp apart
(``chip_smoke.py`` holds them to two ulps of the largest |output|); in
f32 to 1e-4.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

# static symmetric int8 KV quantization scale (repro.models.layers.QSCALE)
QSCALE = 16.0
# pages in one split of a row: 8 pages of 16 tokens
PAGES_PER_SPLIT = 8
# split-kernel CTAs to aim for per SM; CTAs stride over a row's splits
CTAS_PER_SM = 8

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lens):
    """q [B,H,hd]; k_pages/v_pages [NB,BS,KV,hd] (int8 pages are
    dequantised by 1/QSCALE in q's dtype); block_tables [B,MB] (rows
    padded with the null block, masked by ``lens``); lens [B] valid
    positions. Returns [B,H,hd] in q's dtype; scores are scaled by
    hd ** -0.5.

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
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(vd.dtype).float(), vd.float())
    return o.reshape(B, H, hd).to(q.dtype)


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


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if H % KV or H // KV > 16 or hd % 16 or hd > 256:
        raise ValueError(f"kernel takes H % KV == 0, H/KV <= 16, hd a "
                         f"multiple of 16 up to 256; got H={H} KV={KV} "
                         f"hd={hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype not in (q.dtype, torch.int8) \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must be {q.dtype} or int8, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("block_tables and lens must be int32")
    tensors = (q, k_pages, v_pages, block_tables, lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    MB = block_tables.shape[1]
    NS = -(-MB // PAGES_PER_SPLIT)
    grid_x = min(NS, -(-CTAS_PER_SM * _sm_count(q.device) // (B * KV)))
    out = torch.empty_like(q)
    part_o = torch.empty((B, H, NS, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, NS, 2), dtype=torch.float32, device=q.device)
    scale = hd ** -0.5
    kv_scale = 1.0 / QSCALE if k_pages.dtype == torch.int8 else 1.0
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), B, H, KV, hd, BS, MB,
            PAGES_PER_SPLIT, NS, grid_x, scale, kv_scale, _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pages.dtype], stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out

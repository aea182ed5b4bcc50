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

Both take the decode step's KV append too (``k_new``, ``v_new`` and
``slots``): the same launch writes the new token at its slot of the cache
(int8: :func:`quantise_kv`) and attends it beside the cached positions, so
a serving step launches no append of its own. K1 attends the token as the
arena stores it, as the reference's paged branch writes and then reads it
back; K2 attends it unquantised, as the carried branch does. The plain
versions are the two calls the reference makes: append then attend (K1),
attend then append (K2). The two forms agree wherever each row's slot is
its position ``lens[b]`` and no two rows share a slot (inactive rows of a
paged step all write into the null block, and their outputs are read by
no one).

Bound on an H100: bytes, and at serving's short rows latency. A call
reads each valid K/V position once, ``2 * sum(lens) * KV * hd * itemsize``
bytes, for about ``4 * hd * G`` FLOPs per position and KV head (G = H / KV
query heads share it): some G FLOPs per byte in bf16, far below the ~295
at which the card turns compute-bound. Both kernels read each position
once per (row, KV head) for all G heads and stop at the row's length
instead of walking the whole table or cache. :func:`variant` picks the
kernel of a call:

* ``"ring"``: bf16 queries on bf16 or int8 K/V at head dim 64, 80 or 128
  (``RING_HEAD_DIMS``, every config's). Tensor cores (``mma.sync``, the G
  heads padded to 16 rows), each warp fed by its own ring of cp.async
  copies so that loads stay in flight while it computes, the softmax in
  registers, int8 converted in registers. One launch: every CTA reads
  all the call's lens and cuts each row into at most NS splits
  (:func:`ring_splits`) of a length (:func:`split_length`,
  :func:`row_splits`) that spreads the call over the CTAs the card holds
  at once (``RING_RESIDENT_PER_SM``) but holds at least the positions
  of ``MIN_SPLIT_BYTES`` of bf16 K and V; a row of one split is written
  by its CTA, the splits of a longer one are merged, in a fixed order, by
  the CTA that takes the row's last ticket once its partial is stored
  (:func:`_tickets`, left at 0 by every call).
* ``"cuda-core"``: everything else (f32 models, other head dims), in f32
  on the CUDA cores, over fixed splits (``PAGES_PER_SPLIT`` pages,
  ``TOKENS_PER_SPLIT`` positions) that a grid sized to the card
  (``CTAS_PER_SM``) strides over, then a second small kernel that merges
  them, and K2's new token with them, by log-sum-exp.

Precision: the kernels accumulate in f32; the ring kernel rounds the
unnormalised softmax weights to bf16 before the PV product, the plain
versions (like the references) the normalised ones (two-part: the weights
normalised by the running max, not yet by the sum). In bf16 the two land
about one bf16 ulp apart (``chip_smoke.py`` holds them to two ulps of the
largest |output|); in f32 to 1e-4. Two calls on the same inputs give the
same bits.

A row with nothing to attend (``lens == 0`` and no new token) gives 0 in
both kernels and both plain versions; the XLA references give NaN there.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

# static symmetric int8 KV quantization scale (repro.models.layers.QSCALE)
QSCALE = 16.0
# bf16 queries at these head dims take the ring kernel; the rest the
# CUDA-core kernel
RING_HEAD_DIMS = (64, 80, 128)
# the ring kernel's splits: each holds at least the positions of this many
# bf16 K and V bytes of a KV head (fewer, and merging them costs more than
# spreading them saves; an int8 split takes as many positions, since its
# conversion in registers costs about what the bytes it saves did)
MIN_SPLIT_BYTES = 160 * 1024
# ring-kernel CTAs an SM holds at once (45-104 KB of shared memory each):
# a call's splits aim at that many over the card
RING_RESIDENT_PER_SM = 2
# split slots of its grid per SM (CTAs without a split exit at once), and
# the most splits of a row (kMaxSplits in decode_common.cuh)
RING_SLOTS_PER_SM = 8
RING_MAX_SPLITS = 64
# the CUDA-core kernel's splits: 8 pages of a paged row, 128 positions of a
# dense one (a multiple of 64), and the CTAs per SM its grid aims for; its
# CTAs stride over a row's splits
PAGES_PER_SPLIT = 8
TOKENS_PER_SPLIT = 128
CTAS_PER_SM = 8

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_VARIANT_CODE = {"ring": 0, "cuda-core": 1}


def quantise_kv(t, dtype):
    """The new K or V as a cache of ``dtype`` stores it: int8 by
    ``clip(round(t * QSCALE), -127, 127)`` (round half to even), else a
    cast (the reference's ``models.layers`` write)."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(t * QSCALE), -127, 127).to(torch.int8)
    return t.to(dtype)


def update_kv_buffer_plain(k_pages, v_pages, k_new, v_new, slots):
    """k_pages/v_pages [NB,BS,KV,hd]; k_new/v_new [B,KV,hd]; slots [B]
    flat slot indices (block_id * BS + offset). Writes each row at its slot
    in place and returns the pages; slots outside ``[0, NB*BS)`` are
    dropped (the reference's ``mode="drop"``; negative slots, which the
    reference would wrap, are dropped too and never occur on the path)."""
    NB, BS, KV, hd = k_pages.shape
    kf = k_pages.view(NB * BS, KV, hd)
    vf = v_pages.view(NB * BS, KV, hd)
    keep = (slots >= 0) & (slots < NB * BS)
    idx = slots[keep].long()
    kf[idx] = k_new[keep].to(kf.dtype)
    vf[idx] = v_new[keep].to(vf.dtype)
    return k_pages, v_pages


def _append_plain(k, v, k_new, v_new, slots):
    """The step's new token into a cache of token rows (pages, or the
    carried cache's [B,S] rows), quantised as the cache stores it."""
    update_kv_buffer_plain(k, v, quantise_kv(k_new, k.dtype),
                           quantise_kv(v_new, v.dtype), slots)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lens,
                                 k_new=None, v_new=None, slots=None):
    """q [B,H,hd]; k_pages/v_pages [NB,BS,KV,hd] (int8 pages are
    dequantised by 1/QSCALE in q's dtype); block_tables [B,MB] (rows
    padded with the null block, masked by ``lens``); lens [B] valid
    positions (a row of 0 gives 0). Returns [B,H,hd] in q's dtype; scores
    are scaled by hd ** -0.5.

    Gathers each row's pages into [B, MB*BS, KV, hd] and runs the masked
    decode softmax with f32 scores, as ``paged_attention_xla`` and
    ``decode_attention_xla`` do in the JAX package.

    With the step's new token (k_new/v_new [B,KV,hd] in q's dtype, slots
    [B] int32 flat slots of the arena), ``lens`` counts the cached
    positions before it: the token is written at its slot in place
    (:func:`update_kv_buffer_plain` of :func:`quantise_kv`), then
    ``lens + 1`` positions are attended, the reference's paged branch."""
    if k_new is not None:
        _append_plain(k_pages, v_pages, k_new, v_new, slots)
        lens = lens + 1
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


def paged_decode_attention(q, k_pages, v_pages, block_tables, lens,
                           k_new=None, v_new=None, slots=None):
    """Paged decode attention, same contract as
    :func:`paged_decode_attention_plain`: with k_new, v_new and slots, one
    launch writes the step's new token into the arena and attends it.
    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise on what it does not take. ``paged_decode_attention.launches``
    counts kernel launches, ``.fused_launches`` those that wrote a new
    token."""
    _new_token(k_new, v_new, slots)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, lens, k_new, v_new,
                                            slots)
    return _launch(q, k_pages, v_pages, block_tables, lens, k_new, v_new,
                   slots)


paged_decode_attention.launches = 0
paged_decode_attention.fused_launches = 0


def decode_attention_plain(q, k, v, lens, k_new=None, v_new=None,
                           slots=None):
    """q [B,H,hd]; k/v [B,S,KV,hd], one layer of the carried cache (int8
    is dequantised by 1/QSCALE in q's dtype); lens [B] cached positions to
    attend (from S on, all S are). Optionally the step's new token
    k_new/v_new [B,KV,hd] in q's dtype, attended beside the cache and not
    quantised, and with it ``slots`` [B] int32: where it is written after
    the attention, ``b * S + lens[b]`` in the layer's B*S token rows
    (dropped outside them), quantised by :func:`quantise_kv`. Returns
    [B,H,hd] in q's dtype; scores are scaled by hd ** -0.5 and taken in
    f32.

    Without the new token this is ``decode_attention_xla`` of the JAX
    package (a row of ``lens == 0`` gives 0 here, NaN there); with it,
    ``decode_attention_two_part``, including its cast of the weights,
    normalised by the running max only, to the cache's dtype before the
    PV product; with slots, the carried branch's write after it."""
    out = _decode_attention_plain(q, k, v, lens, k_new, v_new)
    if slots is not None:
        _append_plain(k, v, k_new, v_new, slots)
    return out


def _decode_attention_plain(q, k, v, lens, k_new, v_new):
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


def decode_attention(q, k, v, lens, k_new=None, v_new=None, slots=None):
    """Dense-cache decode attention, same contract as
    :func:`decode_attention_plain`: with slots, one launch attends the new
    token and writes it into the cache. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise on what it does not
    take. ``decode_attention.launches`` counts kernel launches,
    ``.fused_launches`` those that wrote a new token."""
    if slots is not None and k_new is None:
        raise ValueError("slots come with the new token k_new/v_new")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lens, k_new, v_new, slots)
    return _launch_dense(q, k, v, lens, k_new, v_new, slots)


decode_attention.launches = 0
decode_attention.fused_launches = 0


def _new_token(k_new, v_new, slots):
    """The paged call's new token: k_new, v_new and slots all given, or
    none of them."""
    if not (k_new is None) == (v_new is None) == (slots is None):
        raise ValueError("give k_new, v_new and slots together, or none")


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def variant(q_dtype, hd: int) -> str:
    """The kernel a call takes: ``"ring"`` for bf16 queries (on bf16 or
    int8 K/V) at a head dim of ``RING_HEAD_DIMS``, else ``"cuda-core"``."""
    if q_dtype == torch.bfloat16 and hd in RING_HEAD_DIMS:
        return "ring"
    return "cuda-core"


def min_split(hd: int) -> int:
    """The ring kernel's shortest split, in positions: ``MIN_SPLIT_BYTES``
    of bf16 K and V of one KV head, in whole 64-position tiles."""
    return -(-MIN_SPLIT_BYTES // (2 * hd * 2 * 64)) * 64


def ring_splits(B: int, KV: int, cap: int, n_sm: int, shortest: int) -> int:
    """Split slots per (row, KV head) of the ring kernel, NS (its grid is
    KV x B x NS): ``RING_SLOTS_PER_SM`` per SM over the B*KV pairs, at
    least 1, and no more than a row of ``cap`` positions can fill with
    splits of ``shortest`` or ``RING_MAX_SPLITS``."""
    fill = RING_SLOTS_PER_SM * n_sm // (B * KV)
    return max(1, min(-(-cap // shortest), fill, RING_MAX_SPLITS))


def split_length(P: int, KV: int, target: int, shortest: int) -> int:
    """The ring kernel's split of a call (the rule of ``split_length`` in
    ``decode_common.cuh``, which every CTA applies to the call's lens): at
    least ``shortest`` positions, and long enough that the call's P valid
    positions over KV heads make about ``target`` splits, in whole
    64-position tiles."""
    fill = -(-P * KV // target)
    return max(shortest, -(-fill // 64) * 64)


def row_splits(n: int, NS: int, split: int):
    """How the ring kernel cuts a row of ``n`` valid positions (the rule of
    ``row_splits`` in ``decode_common.cuh``): at most NS splits of about
    ``split`` positions, as even as whole 64-position tiles allow. Returns
    (splits that run, positions per split); a row with nothing to attend
    runs one, which writes its output."""
    if n <= 0:
        return 1, 64
    per = -(-n // min(NS, -(-n // split)))
    length = -(-per // 64) * 64
    return -(-n // length), length


def plan(q_dtype, hd: int, B: int, KV: int, cap: int, cuda_core_split: int,
         n_sm: int):
    """(variant, split_tokens, NS, grid_x, target) of a call over B rows of
    ``cap`` positions: the ring kernel takes its shortest split, NS = grid_x
    = :func:`ring_splits` and a target of ``RING_RESIDENT_PER_SM`` CTAs
    per SM; the CUDA-core kernel splits of ``cuda_core_split`` positions
    and ``CTAS_PER_SM`` CTAs per SM striding over them."""
    kind = variant(q_dtype, hd)
    if kind == "ring":
        shortest = min_split(hd)
        ns = ring_splits(B, KV, cap, n_sm, shortest)
        return kind, shortest, ns, ns, RING_RESIDENT_PER_SM * n_sm
    ns = -(-cap // cuda_core_split)
    return (kind, cuda_core_split, ns,
            min(ns, -(-CTAS_PER_SM * n_sm // (B * KV))), 0)


_TICKETS: dict = {}


def _tickets(device, n: int) -> torch.Tensor:
    """The ring kernel's ticket counters of one device, at least ``n``
    int32 zeros (one per (row, KV head)). Every call leaves them 0 (the CTA
    that takes a row's last ticket resets it), so one array serves all
    calls, which run in order on the current stream."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


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


def _scratch(q, KV, cap, cuda_core_split):
    """The call's plan, output and scratch: split partials (o [B,H,NS,hd],
    (m, l) [B,H,NS,2] f32) and the ticket counters."""
    B, H, hd = q.shape
    kind, *how = plan(q.dtype, hd, B, KV, cap, cuda_core_split,
                      _sm_count(q.device))
    ns = how[1]
    part_o = torch.empty((B, H, ns, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, ns, 2), dtype=torch.float32, device=q.device)
    return ((_VARIANT_CODE[kind], *how), torch.empty_like(q), part_o,
            part_ml, _tickets(q.device, B * KV))


def _check_new(q, KV, k_new, v_new, slots):
    """The new token k_new/v_new [B,KV,hd] in q's dtype and its int32
    slots [B], when given; returns the tensors to check with the rest."""
    if k_new is None:
        return []
    B, _, hd = q.shape
    if k_new.shape != (B, KV, hd) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new [B,KV,hd] expected, got "
                         f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError(f"k_new/v_new must be {q.dtype}, got "
                        f"{k_new.dtype}/{v_new.dtype}")
    if slots is None:
        return [k_new, v_new]
    if slots.shape != (B,) or slots.dtype != torch.int32:
        raise ValueError(f"slots [B] int32 expected, got "
                         f"{tuple(slots.shape)} {slots.dtype}")
    return [k_new, v_new, slots]


def _ptrs(*tensors):
    """Device pointers, 0 for an absent tensor."""
    return [0 if t is None else t.data_ptr() for t in tensors]


def _launch(q, k_pages, v_pages, block_tables, lens, k_new, v_new, slots):
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
           [q, k_pages, v_pages, block_tables, lens]
           + _check_new(q, KV, k_new, v_new, slots))
    MB = block_tables.shape[1]
    how, out, part_o, part_ml, tickets = _scratch(q, KV, MB * BS,
                                                  PAGES_PER_SPLIT * BS)
    kv_scale = 1.0 / QSCALE if k_pages.dtype == torch.int8 else 1.0
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_launch(
            *_ptrs(q, k_pages, v_pages, block_tables, lens, k_new, v_new,
                   slots), NB * BS,
            *_ptrs(out, part_o, part_ml, tickets), B, H, KV, hd, BS, MB,
            *how, hd ** -0.5, kv_scale, _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pages.dtype], stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    paged_decode_attention.fused_launches += k_new is not None
    return out


def _launch_dense(q, k, v, lens, k_new, v_new, slots):
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
    if (k_new is None) != (v_new is None):
        raise ValueError("give both k_new and v_new, or neither")
    _check(q, KV, k, v, "cache",
           [q, k, v, lens] + _check_new(q, KV, k_new, v_new, slots))
    how, out, part_o, part_ml, tickets = _scratch(q, KV, S, TOKENS_PER_SPLIT)
    kv_scale = 1.0 / QSCALE if k.dtype == torch.int8 else 1.0
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dense_decode_attention_launch(
            *_ptrs(q, k, v, k_new, v_new, slots, lens, out, part_o, part_ml,
                   tickets), B, H, KV, hd, S, *how, hd ** -0.5, kv_scale,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    decode_attention.fused_launches += slots is not None
    return out

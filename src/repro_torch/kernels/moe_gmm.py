"""The grouped (ragged) matmul of the MoE expert FFNs, forward (K6) and
gradient (K6b): each a wrapper around hand-written CUDA kernels beside its
plain PyTorch version.

The rows of ``x [T, K]`` form a table of tiles of ``tile_m`` rows: tile t
is rows ``[t tile_m, (t+1) tile_m)`` and belongs to expert
``tile_expert[t]`` (int32 on the device, never read by the host). The
reference's ``gmm`` (``src/repro/kernels/moe_gmm.py``) takes tiles of 128
rows of a sorted, padded token list (:func:`~repro_torch.kernels.ops.
moe_gmm_apply` builds one); the port's ``moe_mlp`` gives every expert one
tile of its n·C dispatched rows, which need not be a multiple of anything
(4 rows in a decode step).

* :func:`gmm_plain` multiplies each tile by its expert's ``w [K, N]`` (or
  ``[N, K]`` read transposed) in float32 and rounds once to x's dtype, as
  the reference's Pallas body does; :func:`gmm_dw_plain` sums ``x_t^T
  dy_t`` over the tiles of each expert in float32;
  :func:`gmm_backward_plain` is the gradient from both.
* :func:`gmm_fwd` (K6) and :func:`gmm_bwd` (K6b: dx by K6's kernels over
  the transposed weight, no copy of it, then dw) launch the kernels of
  ``csrc/moe_gmm.cu`` on CUDA tensors, one launch each for the forward,
  dx and dw. In bf16 a tile of more than 16 rows, and every dw, runs on
  the card's tensor cores through ``wgmma`` fed by TMA: at the training
  shape a product is bound by operations (0.19 ms at 989 TFLOP/s), a
  decode step's (4 rows) by reading every expert's weight, which its
  ``mma.sync`` variant streams. In f32 a tile of at most 16 rows (decode;
  the forward and dx) streams the weight through a ring of asynchronous
  copies and multiplies in exact f32 on the CUDA cores; larger tiles and
  every dw run split TF32 on the tensor cores (``mma.sync``: each product
  ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` of tf32 parts, summed in f32). The
  file's note has the design.

Tile edges: the kernels see x, dy and the output as ``[tiles, tile_m,
*]``, so rows past a tile's end read as zeros and are not written, for
any ``tile_m``. A tile whose expert id lies outside [0, E) gives zero
rows and adds nothing to dw; an expert without tiles gets a zero dw.
Each output element is a float32 sum in a fixed order (dw over its
expert's tiles in table order; f32 decode tiles as eight partial sums
added in order; f32 tiles of split-TF32 products a depth step of 8), rounded
once: two calls give the same bits. K must be a multiple of 32 and N of 8, and the tensors 16-byte
aligned (the reference asserts that its 128 tiles divide T, D and F).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
K_MULTIPLE, N_MULTIPLE = 32, 8


def _tiles(x, tile_m: int) -> int:
    T = x.shape[0]
    if tile_m <= 0 or T % tile_m:
        raise ValueError(f"{T} rows do not split into tiles of {tile_m}")
    return T // tile_m


def gmm_plain(x, w, tile_expert, tile_m: int, *, transpose_w: bool = False):
    """x [T, K]; w [E, K, N] (``transpose_w``: [E, N, K]); tile_expert
    [T // tile_m] int -> [T, N] in x's dtype: each tile of rows times its
    expert's weight, in float32; a tile whose expert id lies outside [0,
    E) gives zero rows, as the kernel's do."""
    nt = _tiles(x, tile_m)
    te, valid = _experts(tile_expert, w.shape[0])
    ws = w[te].float()                                  # [nt, K, N]
    if transpose_w:
        ws = ws.transpose(1, 2)
    out = torch.bmm(x.reshape(nt, tile_m, -1).float(), ws)
    out = out * valid[:, None, None]
    return out.reshape(x.shape[0], -1).to(x.dtype)


def _experts(tile_expert, E: int):
    """Each tile's expert id clamped into [0, E), and whether it was in
    range (float32)."""
    te = tile_expert.long()
    return te.clamp(0, E - 1), ((te >= 0) & (te < E)).float()


def gmm_dw_plain(x, dy, tile_expert, tile_m: int, n_experts: int):
    """x [T, M]; dy [T, N] -> dw [E, M, N] in x's dtype: the sum over the
    tiles of each expert of ``x_t^T dy_t`` in float32 (zeros for an expert
    without tiles; a tile whose expert id lies outside [0, E) adds
    nothing)."""
    nt = _tiles(x, tile_m)
    te, valid = _experts(tile_expert, n_experts)
    part = torch.bmm(x.reshape(nt, tile_m, -1).float().transpose(1, 2),
                     dy.reshape(nt, tile_m, -1).float())
    dw = torch.zeros((n_experts,) + part.shape[1:], dtype=torch.float32,
                     device=x.device)
    return dw.index_add_(0, te, part * valid[:, None, None]).to(x.dtype)


def gmm_backward_plain(x, w, tile_expert, tile_m: int, dy):
    """The gradient of :func:`gmm_plain` (w not transposed) for the
    cotangent ``dy [T, N]``: ``(dx [T, K], dw [E, K, N])``."""
    return (gmm_plain(dy, w, tile_expert, tile_m, transpose_w=True),
            gmm_dw_plain(x, dy, tile_expert, tile_m, w.shape[0]).to(w.dtype))


def _check(x, w, tile_expert, tile_m: int, transpose_w: bool, extra=()):
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"x [T,K] and w [E,K,N] expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    nt = _tiles(x, tile_m)
    E = w.shape[0]
    K, N = (w.shape[2], w.shape[1]) if transpose_w else w.shape[1:]
    if x.shape[1] != K:
        raise ValueError(f"x has depth {x.shape[1]}, the weight {K}")
    if K % K_MULTIPLE or N % N_MULTIPLE:
        raise ValueError(f"the kernels take K a multiple of {K_MULTIPLE} and "
                         f"N of {N_MULTIPLE}, got K={K}, N={N}")
    if tile_expert.shape != (nt,) or tile_expert.dtype != torch.int32:
        raise ValueError(f"tile_expert must be int32 [{nt}], got "
                         f"{tile_expert.dtype} {tuple(tile_expert.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x and w must share one of float32 and bfloat16, "
                        f"got {x.dtype}, {w.dtype}")
    tensors = (x, w, tile_expert) + tuple(extra)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, w) + tuple(extra)):
        raise ValueError("x, w and dy must be 16-byte aligned")
    return nt, E, K, N


def _launch_fwd(x, w, tile_expert, tile_m, transpose_w, what):
    nt, E, K, N = _check(x, w, tile_expert, tile_m, transpose_w)
    out = torch.empty((x.shape[0], N), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gmm_fwd_launch(
            x.data_ptr(), w.data_ptr(), tile_expert.data_ptr(),
            out.data_ptr(), nt, tile_m, E, K, N, int(transpose_w),
            _DTYPE_CODE[x.dtype], stream)
    _build.check(err, what)
    return out


def _launch_dw(x, dy, tile_expert, tile_m, n_experts):
    nt = x.shape[0] // tile_m
    M, N = x.shape[1], dy.shape[1]
    dw = torch.empty((n_experts, M, N), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gmm_dw_launch(
            x.data_ptr(), dy.data_ptr(), tile_expert.data_ptr(),
            dw.data_ptr(), nt, tile_m, n_experts, M, N, _DTYPE_CODE[x.dtype],
            stream)
    _build.check(err, "gmm_bwd (dw)")
    return dw


def gmm_fwd(x, w, tile_expert, tile_m: int, *, transpose_w: bool = False):
    """K6, same contract as :func:`gmm_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise on what it does not
    take. A tile whose expert id lies outside [0, E) comes out zero.
    ``gmm_fwd.launches`` counts calls that launch."""
    if x.device.type == "cpu":
        return gmm_plain(x, w, tile_expert, tile_m, transpose_w=transpose_w)
    out = _launch_fwd(x, w, tile_expert, tile_m, transpose_w, "gmm_fwd")
    gmm_fwd.launches += 1
    return out


gmm_fwd.launches = 0


def gmm_bwd(x, w, tile_expert, tile_m: int, dy):
    """K6b, same contract as :func:`gmm_backward_plain`: dx through K6's
    kernel over the transposed weight and dw through the weight-gradient
    kernel. CPU tensors take the plain version; CUDA tensors launch the
    kernels, or raise on what they do not take. ``gmm_bwd.launches``
    counts calls that launch."""
    if x.device.type == "cpu":
        return gmm_backward_plain(x, w, tile_expert, tile_m, dy)
    _, E, _, N = _check(x, w, tile_expert, tile_m, False, (dy,))
    if dy.shape != (x.shape[0], N) or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {x.dtype} [{x.shape[0]}, {N}], got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    dx = _launch_fwd(dy, w, tile_expert, tile_m, True, "gmm_bwd (dx)")
    dw = _launch_dw(x, dy, tile_expert, tile_m, E)
    gmm_bwd.launches += 1
    return dx, dw


gmm_bwd.launches = 0

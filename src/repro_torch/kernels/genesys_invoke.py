"""The device entry of ``Genesys.invoke``: card threads post GENESYS's
64-byte slots into mapped host memory (``csrc/genesys_invoke.cu`` over
``csrc/genesys_protocol.cuh``).

It replaces no Pallas kernel: the JAX package reaches the host through a
host callback inside the jitted step (``Genesys._host_entry``,
``src/repro/core/genesys/invoke.py``). Here row ``i`` of a call's
``[n, 6, 2]`` int32 arguments goes to slot ``(base + i) % n_slots`` of a
:class:`~repro_torch.core.genesys.device.DeviceSyscallArea`, which a host
thread watches (``core/genesys/device.py``).

:func:`post_rows` launches the kernel for rows on the card; on rows that
lie on the CPU it runs :func:`post_rows_plain`, which performs the
kernel's writes on the area in the same order. Nothing on a path with a
card calls the plain version. ``post_rows.launches`` counts launches.
:func:`doorbell` is the host's side in C: the poller of a mapped area
spins in it (``csrc/genesys_doorbell.cuh``), and the poller's Python scan
of a numpy area is its plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.genesys.area import SlotState
from repro_torch.kernels import _build

ETIMEDOUT = 110
# what the status word holds when a bound runs out (genesys_protocol.cuh)
ERRORS = {1: "waiting for the slot's owner word",
          2: "waiting for the slot to be FREE",
          3: "waiting for the host's answer (FINISHED)"}
STATUS_WORDS = 16                   # one 64-byte line after the slots
_BLOCKING = 0x1
_POLL_S = 20e-6
# the plain version's stand-in for the card's atomics on the owner words
_OWNER_ATOMICS = threading.Lock()


def _i32(v: int) -> int:
    """The signed 32-bit pattern of ``v``'s low word (a C ``int``)."""
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _deadline_passed(deadline: float) -> bool:
    return time.monotonic() > deadline


def _wait_state(slots, slot: int, want: SlotState, deadline: float) -> bool:
    while int(slots["state"][slot]) != want:
        if _deadline_passed(deadline):
            return False
        time.sleep(_POLL_S)
    return True


def _report(status: np.ndarray, err: int, slot: int) -> None:
    status[1] = slot
    status[0] = err


def _post_one(area, owner, slot, sysno, args, flags, hw_id, deadline) -> int:
    """genesys_post: take the owner word, wait for FREE, POPULATING,
    payload, READY; a non-blocking call gives the owner word back."""
    while True:
        with _OWNER_ATOMICS:
            if owner[slot] == 0:
                owner[slot] = 1
                break
        if _deadline_passed(deadline):
            return 1
        time.sleep(_POLL_S)
    slots = area.slots
    if not _wait_state(slots, slot, SlotState.FREE, deadline):
        owner[slot] = 0
        return 2
    slots["state"][slot] = int(SlotState.POPULATING)
    rec = slots[slot]
    rec["sysno"] = sysno
    rec["args"] = args
    rec["flags"] = flags
    rec["hw_id"] = hw_id
    slots["state"][slot] = int(SlotState.READY)
    if not flags & _BLOCKING:
        owner[slot] = 0
    return 0


def _wait_one(area, owner, slot, deadline) -> tuple[int, int]:
    """genesys_wait: FINISHED, read args[0], FREE, give the owner back."""
    slots = area.slots
    if not _wait_state(slots, slot, SlotState.FINISHED, deadline):
        return 3, 0
    ret = int(slots["args"][slot, 0])
    slots["state"][slot] = int(SlotState.FREE)
    owner[slot] = 0
    return 0, ret


def _join(rows: np.ndarray) -> np.ndarray:
    m32 = np.uint64(0xFFFFFFFF)
    return ((rows[..., 1].astype(np.uint64) & m32) << np.uint64(32)) | (
        rows[..., 0].astype(np.uint64) & m32)


def post_rows_plain(area, owner: np.ndarray, rows: np.ndarray, *, base: int,
                    sysno: int, flags: int, hw_id: int, timeout_s: float
                    ) -> np.ndarray | None:
    """The kernel's writes on ``area`` (a ``DeviceSyscallArea``) for
    ``rows`` ``[n, 6, 2]`` int32, in its order: each row takes its slot's
    owner word, waits for FREE, writes POPULATING, the payload and READY;
    a blocking row then waits for FINISHED, reads ``args[0]`` and writes
    FREE. The card's threads run at once; here rows post in waves of at
    most ``n_slots`` (so that no two rows of a wave share a slot), and a
    wave's blocking rows are waited for before the next wave posts.

    Returns the ``[n, 2]`` int32 (lo, hi) return values of a blocking call
    (``-ETIMEDOUT`` where a bound ran out, which also sets
    ``area.status``), else None."""
    rows = np.asarray(rows, dtype=np.int32)
    n, n_slots = len(rows), area.n_slots
    joined = _join(rows)
    rets = np.zeros(n, dtype=np.uint64)
    blocking = bool(flags & _BLOCKING)
    for lo in range(0, n, n_slots):
        posted = []
        for i in range(lo, min(n, lo + n_slots)):
            slot = (base + i) % n_slots
            err = _post_one(area, owner, slot, sysno, joined[i], flags,
                            hw_id, time.monotonic() + timeout_s)
            if err:
                _report(area.status, err, slot)
                rets[i] = np.uint64(-ETIMEDOUT & 0xFFFFFFFFFFFFFFFF)
            elif blocking:
                posted.append((i, slot))
        for i, slot in posted:
            err, ret = _wait_one(area, owner, slot,
                                 time.monotonic() + timeout_s)
            if err:
                _report(area.status, err, slot)
                ret = -ETIMEDOUT & 0xFFFFFFFFFFFFFFFF
            rets[i] = np.uint64(ret)
    if not blocking:
        return None
    out = np.empty((n, 2), dtype=np.int32)
    out[:, 0] = (rets & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    out[:, 1] = (rets >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return out


def post_rows(area, owner, rows, *, base: int, sysno: int, flags: int,
              hw_id: int, timeout_s: float, stream=None, out=None, tag=None):
    """Post ``rows`` ``[n, 6, 2]`` int32 into ``area``; same contract as
    :func:`post_rows_plain`, whose return values come back in an int32
    tensor of ``2 n`` elements on the rows' device: ``out`` if given (any
    shape), else a new ``[n, 2]``. ``tag``, a float32 tensor if given, is
    set to 0 once the values are in (the post-barrier). Rows on the CPU
    take the plain version (``owner`` a numpy int32 array); rows on the
    card launch the kernel on ``stream`` (``owner`` an int32 tensor on the
    card, ``area`` mapped: ``area.dev_ptr`` set), which returns at once:
    the values land when the kernel ends."""
    if rows.dim() != 3 or tuple(rows.shape[1:]) != (6, 2) \
            or rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32 [n, 6, 2], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    n = rows.shape[0]
    blocking = bool(flags & _BLOCKING)
    if blocking and out is None:
        out = torch.empty((n, 2), dtype=torch.int32, device=rows.device)
    if out is not None and (out.dtype != torch.int32 or out.numel() != 2 * n
                            or out.device != rows.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be {2 * n} contiguous int32 on "
                         f"{rows.device}")
    if tag is not None and (tag.dtype != torch.float32
                            or tag.device != rows.device):
        raise ValueError(f"tag must be float32 on {rows.device}")
    if rows.device.type == "cpu":
        ret = post_rows_plain(area, owner, rows.numpy(), base=base,
                              sysno=sysno, flags=flags, hw_id=hw_id,
                              timeout_s=timeout_s)
        if not blocking:
            return None
        out.view(n, 2).copy_(torch.from_numpy(ret))
        if tag is not None:
            tag.zero_()
        return out
    if getattr(area, "dev_ptr", None) is None:
        raise ValueError("rows on the card need an area in mapped memory")
    if owner.device != rows.device or owner.dtype != torch.int32 \
            or owner.shape != (area.n_slots,):
        raise ValueError(f"owner must be int32 [{area.n_slots}] on "
                         f"{rows.device}")
    if n == 0:
        return out if blocking else None
    rows = rows.contiguous()
    if stream is None:
        stream = torch.cuda.current_stream(rows.device)
    # the launch goes to the current device's context: switch only if the
    # rows live on another card
    guard = (contextlib.nullcontext()
             if rows.device.index == torch.cuda.current_device()
             else torch.cuda.device(rows.device))
    with guard:
        err = _build.library().genesys_invoke_launch(
            area.dev_ptr, owner.data_ptr(), area.n_slots, base % area.n_slots,
            rows.data_ptr(), n, _i32(sysno), _i32(flags), _i32(hw_id),
            out.data_ptr() if blocking else 0,
            tag.data_ptr() if blocking and tag is not None else 0,
            area.status_dev_ptr, int(timeout_s * 1e9), stream.cuda_stream)
    _build.check(err, "genesys_invoke")
    post_rows.launches += 1
    return out if blocking else None


post_rows.launches = 0


class Doorbell(NamedTuple):
    """The native doorbell (``csrc/genesys_doorbell.cuh``): ``scan``, one
    pass over a window of slots (``genesys_doorbell_scan``), and ``wait``,
    which spins over it (``genesys_doorbell_wait``)."""
    scan: Callable
    wait: Callable


@functools.lru_cache(maxsize=1)
def doorbell() -> Doorbell:
    """The native doorbell of the kernel library. ``wait`` goes through a
    ``ctypes.CDLL`` handle, which releases the GIL while it spins; ``scan``
    through the library's own ``PyDLL`` handle, which keeps it: one pass
    takes well under a µs, and a GIL handed over and back costs the
    poller tens of µs while the caller's thread is between CUDA calls.
    Builds the library on first use and raises if it cannot be built or
    loaded."""
    wait = ctypes.CDLL(str(_build.build())).genesys_doorbell_wait
    wait.argtypes, wait.restype = _build.SIGNATURES["genesys_doorbell_wait"]
    return Doorbell(_build.library().genesys_doorbell_scan, wait)


def alloc_mapped(nbytes: int, device: torch.device) -> tuple[int, int]:
    """Page-locked host memory mapped into the card's address space
    (``cudaHostAlloc`` with ``cudaHostAllocMapped | cudaHostAllocPortable``),
    zeroed; returns its host and device addresses."""
    lib = _build.library()
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    with torch.cuda.device(device):
        err = lib.genesys_mapped_alloc(int(nbytes), ctypes.byref(host),
                                       ctypes.byref(dev))
    _build.check(err, "genesys_mapped_alloc")
    return host.value, dev.value


def free_mapped(host: int) -> None:
    _build.check(_build.library().genesys_mapped_free(host),
                 "genesys_mapped_free")


def device_attributes(device: torch.device) -> dict:
    """What the card says about host memory. The protocol relies on no
    ``host_native_atomics`` (expect 0 on an x86 host)."""
    out = (ctypes.c_int * 3)()
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    _build.check(_build.library().genesys_device_attributes(idx, out),
                 "genesys_device_attributes")
    return dict(zip(("host_native_atomics", "can_map_host_memory",
                     "unified_addressing"), (int(v) for v in out)))

"""Syscall area: the shared-memory slot array of GENESYS (paper Figs 3-4).

Each slot is 64 bytes (one cache line, to avoid false sharing — paper §5):

    u32  sysno      requested system call number
    u32  state      slot state machine (Fig 4)
    u64  args[6]    up to 6 arguments (Linux max); args[0] doubles as retval
    u32  flags      bit0: blocking, bits1-2: ordering, bits3-4: granularity
    u32  hw_id      requestor "hardware id" (device/lane), for diagnostics

State machine (paper Fig 4):

    FREE -> POPULATING -> READY -> PROCESSING -> FINISHED -> FREE   (blocking)
    FREE -> POPULATING -> READY -> PROCESSING -> FREE               (non-blocking)

The GPU's atomic CAS on slot state is emulated with a per-area lock; the
transition *set* is identical and unit/property-tested in
tests/test_genesys_area.py.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import IntEnum

import numpy as np


class SlotState(IntEnum):
    FREE = 0
    POPULATING = 1
    READY = 2
    PROCESSING = 3
    FINISHED = 4


SLOT_DTYPE = np.dtype(
    [
        ("sysno", np.uint32),
        ("state", np.uint32),
        ("args", np.uint64, (6,)),
        ("flags", np.uint32),
        ("hw_id", np.uint32),
    ],
    align=True,
)
SLOT_BYTES = SLOT_DTYPE.itemsize
assert SLOT_BYTES == 64, f"slot must be one 64B cache line, got {SLOT_BYTES}"

FLAG_BLOCKING = 0x1

# Legal transitions, keyed by (from, to). Mirrors paper Fig 4.
_LEGAL = {
    (SlotState.FREE, SlotState.POPULATING),
    (SlotState.POPULATING, SlotState.READY),
    (SlotState.POPULATING, SlotState.FREE),        # abort populate
    (SlotState.READY, SlotState.PROCESSING),
    (SlotState.PROCESSING, SlotState.FINISHED),    # blocking completion
    (SlotState.PROCESSING, SlotState.FREE),        # non-blocking completion
    (SlotState.FINISHED, SlotState.FREE),          # caller consumed result
}


class IllegalTransition(RuntimeError):
    pass


@dataclass
class Ticket:
    """Handle for a posted syscall: slot index + generation (ABA guard)."""
    slot: int
    gen: int


class SyscallArea:
    """Fixed-size ring of 64-byte syscall slots.

    The paper sizes the area to one slot per *active* work-item (1.25 MB
    total). We default to 4096 slots (256 KB) — one per in-flight request,
    allocated from a free list keyed by hardware id.
    """

    def __init__(self, n_slots: int = 4096):
        self.n_slots = int(n_slots)
        self.slots = np.zeros(self.n_slots, dtype=SLOT_DTYPE)
        self._gen = np.zeros(self.n_slots, dtype=np.int64)
        self._lock = threading.Lock()
        self._free = list(range(self.n_slots - 1, -1, -1))
        self._finished = threading.Condition(self._lock)
        self._carved = 0          # slots lent out to partitions (see carve())

    # -- partitioning (genesys.sched per-tenant rings) -------------------------
    def carve(self, n: int) -> "SyscallArea":
        """Split off a partition of ``n`` slots for a tenant ring.

        The partition shares this area's backing ``slots``/generation arrays
        — global slot indices stay valid for the executor and ring bundles —
        but owns its own lock and free list over a disjoint slot set, so one
        tenant exhausting its partition never blocks another tenant's
        acquire. Return the slots with :meth:`reclaim`.
        """
        n = int(n)
        with self._lock:
            if n <= 0 or n > len(self._free):
                raise ValueError(
                    f"cannot carve {n} slots: {len(self._free)} free "
                    f"of {self.n_slots}")
            taken = [self._free.pop() for _ in range(n)]
            self._carved += n
        part = SyscallArea.__new__(SyscallArea)
        part.n_slots = n
        part.slots = self.slots          # shared backing array: the partition
        part._gen = self._gen            # is a *range of the same area*
        part._lock = threading.Lock()
        part._free = taken
        part._finished = threading.Condition(part._lock)
        part._carved = 0
        return part

    def reclaim(self, part: "SyscallArea") -> None:
        """Return a (drained) partition's slots to this area's free list."""
        with part._lock:
            if len(part._free) != part.n_slots:
                raise RuntimeError(
                    f"partition still has {part.n_slots - len(part._free)} "
                    "slots in flight")
            slots, part._free = part._free, []
            part.n_slots = 0
        with self._lock:
            self._free.extend(slots)
            self._carved -= len(slots)
            self._finished.notify_all()

    # -- atomic state transitions ------------------------------------------
    def _cas(self, slot: int, old: SlotState, new: SlotState) -> bool:
        """Emulated compare-and-swap on the slot state word."""
        cur = SlotState(int(self.slots[slot]["state"]))
        if cur != old:
            return False
        if (old, new) not in _LEGAL:
            raise IllegalTransition(f"slot {slot}: {old.name} -> {new.name}")
        self.slots[slot]["state"] = int(new)
        return True

    def transition(self, slot: int, old: SlotState, new: SlotState) -> bool:
        with self._lock:
            ok = self._cas(slot, old, new)
            if ok and new in (SlotState.FINISHED, SlotState.FREE):
                self._finished.notify_all()
            return ok

    # -- device-side API ----------------------------------------------------
    def acquire(self, hw_id: int) -> Ticket:
        """FREE -> POPULATING; blocks (paper: 'invocation is delayed') if the
        area is exhausted until a slot frees up."""
        with self._lock:
            while not self._free:
                self._finished.wait()
            slot = self._free.pop()
            if not self._cas(slot, SlotState.FREE, SlotState.POPULATING):
                raise IllegalTransition(f"free-list slot {slot} not FREE")
            self.slots[slot]["hw_id"] = hw_id
            self._gen[slot] += 1
            return Ticket(slot=slot, gen=int(self._gen[slot]))

    def post(self, t: Ticket, sysno: int, args, blocking: bool) -> None:
        """POPULATING -> READY with the request payload (paper Fig 3)."""
        a = np.zeros(6, dtype=np.uint64)
        for i, v in enumerate(args[:6]):
            a[i] = np.uint64(int(v) & 0xFFFFFFFFFFFFFFFF)
        with self._lock:
            rec = self.slots[t.slot]
            rec["sysno"] = sysno
            rec["args"] = a
            rec["flags"] = FLAG_BLOCKING if blocking else 0
            if not self._cas(t.slot, SlotState.POPULATING, SlotState.READY):
                raise IllegalTransition(f"slot {t.slot} not POPULATING on post")

    def wait(self, t: Ticket, timeout: float | None = None) -> int:
        """Block until FINISHED (the paper's GPU-side poll/suspend), consume
        the retval, release the slot. Returns the syscall return value."""
        with self._lock:
            while True:
                if self._gen[t.slot] != t.gen:
                    # slot already retired and reused: the call was
                    # non-blocking, so its result is not retrievable (paper:
                    # non-blocking callers never observe the retval)
                    return 0
                st = SlotState(int(self.slots[t.slot]["state"]))
                if st == SlotState.FINISHED:
                    ret = int(np.int64(np.uint64(self.slots[t.slot]["args"][0])))
                    self._cas(t.slot, SlotState.FINISHED, SlotState.FREE)
                    self._free.append(t.slot)
                    self._finished.notify_all()
                    return ret
                if st == SlotState.FREE:   # non-blocking call already retired
                    self._free.append(t.slot)
                    self._finished.notify_all()
                    return 0
                if not self._finished.wait(timeout=timeout):
                    raise TimeoutError(f"syscall slot {t.slot} timed out")

    # -- batched device-side API (genesys.uring submission path) --------------
    def acquire_post_np(self, sysnos: np.ndarray, args: np.ndarray,
                        hw_id: int = 0) -> np.ndarray:
        """Acquire + populate + READY a batch of non-blocking slots under
        one lock round (the ring submitter's path: per-call cost is the
        payload write, not a lock/CAS handshake per call). ``sysnos`` is
        ``[k]``, ``args`` is ``[k, 6]`` uint64 (already masked). All slot
        records are populated with numpy fancy-index writes — no
        per-entry Python loop under the area lock — and the acquired slot
        indices come back as an int64 array (the ring path never needs
        full Tickets).

        Slots are popped off the free-list tail in LIFO order, exactly as
        serial :meth:`acquire` would hand them out. Blocks (in sub-chunks)
        while the area is exhausted.
        """
        n = len(sysnos)
        out = np.empty(n, dtype=np.int64)
        ready = int(SlotState.READY)
        free = int(SlotState.FREE)
        i = 0
        with self._lock:
            states = self.slots["state"]
            while i < n:
                while not self._free:
                    self._finished.wait()
                k = min(n - i, len(self._free))
                # LIFO: the last k free slots, most-recently-freed first
                chunk = self._free[-k:]
                chunk.reverse()
                del self._free[-k:]
                slot_arr = np.asarray(chunk, dtype=np.int64)
                # hot path: FREE -> POPULATING -> READY inlined (both legal
                # per Fig 4; the lock makes the pair atomic anyway)
                if (states[slot_arr] != free).any():
                    bad = slot_arr[states[slot_arr] != free]
                    raise IllegalTransition(
                        f"free-list slots {bad.tolist()} not FREE")
                self._gen[slot_arr] += 1
                recs = self.slots
                recs["hw_id"][slot_arr] = hw_id
                recs["sysno"][slot_arr] = sysnos[i:i + k]
                recs["args"][slot_arr] = args[i:i + k]
                recs["flags"][slot_arr] = 0          # ring slots: non-blocking
                states[slot_arr] = ready
                out[i:i + k] = slot_arr
                i += k
        return out

    # -- CPU-side API (executor) ---------------------------------------------
    def claim_for_processing(self, slot: int) -> bool:
        """READY -> PROCESSING (paper: worker 'atomically switches ready')."""
        return self.transition(slot, SlotState.READY, SlotState.PROCESSING)

    def complete(self, slot: int, retval: int) -> None:
        """Write retval; FINISHED for blocking calls, FREE for non-blocking."""
        with self._lock:
            rec = self.slots[slot]
            rec["args"][0] = np.uint64(int(retval) & 0xFFFFFFFFFFFFFFFF)
            blocking = bool(rec["flags"] & FLAG_BLOCKING)
            if blocking:
                ok = self._cas(slot, SlotState.PROCESSING, SlotState.FINISHED)
            else:
                ok = self._cas(slot, SlotState.PROCESSING, SlotState.FREE)
                if ok:
                    self._free.append(slot)
            if not ok:
                raise IllegalTransition(f"slot {slot} not PROCESSING on complete")
            self._finished.notify_all()

    # -- batched CPU-side API (genesys.uring worker path) ----------------------
    def claim_many(self, slots) -> None:
        """READY -> PROCESSING for a whole ring bundle, one lock round and
        one fancy-index write (no per-slot Python loop)."""
        ready, proc = int(SlotState.READY), int(SlotState.PROCESSING)
        arr = np.asarray(slots, dtype=np.int64)
        with self._lock:
            states = self.slots["state"]
            if (states[arr] != ready).any():
                bad = arr[states[arr] != ready]
                raise IllegalTransition(f"ring slots {bad.tolist()} not READY")
            states[arr] = proc

    def complete_many(self, slots, retvals) -> None:
        """Retire a ring bundle: write retvals, PROCESSING -> FREE for all
        (ring slots are always non-blocking), ONE wakeup for the area.
        Retval writes and state flips are vectorized fancy-index ops."""
        proc, free = int(SlotState.PROCESSING), int(SlotState.FREE)
        arr = np.asarray(slots, dtype=np.int64)
        rets = np.fromiter((int(r) & 0xFFFFFFFFFFFFFFFF for r in retvals),
                           dtype=np.uint64, count=len(arr))
        with self._lock:
            states = self.slots["state"]
            if (states[arr] != proc).any():
                bad = arr[states[arr] != proc]
                raise IllegalTransition(
                    f"ring slots {bad.tolist()} not PROCESSING")
            self.slots["args"][arr, 0] = rets
            states[arr] = free
            self._free.extend(arr.tolist())
            self._finished.notify_all()

    # -- introspection -------------------------------------------------------
    def state_of(self, slot: int) -> SlotState:
        return SlotState(int(self.slots[slot]["state"]))

    @property
    def bytes(self) -> int:
        return self.n_slots * SLOT_BYTES

    def in_flight(self) -> int:
        with self._lock:
            return self.n_slots - len(self._free) - self._carved

"""The device side of GENESYS on the card: a slot area the card's threads
write themselves, and the host thread that answers them.

The JAX package emulates the GPU's slot protocol through a host callback
(``repro.core.genesys.invoke``). Here the card does what the paper's GPU
does:

* :class:`DeviceSyscallArea` is a :class:`SyscallArea` whose ``slots`` is a
  numpy ``SLOT_DTYPE`` view of page-locked host memory mapped into the
  card's address space (or plain numpy, for the plain version on the CPU).
  The card allocates its slots itself (``kernels/csrc/genesys_protocol.cuh``),
  so the host free list stays empty: completing a slot never grows it.
* :class:`DevicePoller` is the doorbell: a host thread that scans the
  area's state words for READY slots and calls ``executor.interrupt(slot,
  area=...)`` for each, so the executor claims, dispatches and completes
  it as any other slot. Rows flagged for the ring go through
  ``SyscallRing.submit_np`` as one batch instead, and the poller writes
  each result back into its slot. It parks while no device call is
  outstanding: a poller that spins takes the GIL from the caller.
* :class:`DevicePlane` is what ``Genesys.invoke`` uses on a card: the area,
  the owner words, the poller, a side stream, and the launch of
  ``kernels.genesys_invoke.post_rows``.
"""
from __future__ import annotations

import ctypes
import threading
import time
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core.genesys.area import (
    FLAG_BLOCKING, SLOT_BYTES, SLOT_DTYPE, IllegalTransition, SlotState,
    SyscallArea)
from repro_torch.kernels import genesys_invoke as gi

# a slot flag beside FLAG_BLOCKING (area.py leaves bits 1-4 to ordering and
# granularity): the row goes through the submission ring
FLAG_RING = 0x20
# a device call's bound on each of its waits (seconds, %globaltimer)
TIMEOUT_S = 10.0


class DeviceSyscallArea(SyscallArea):
    """A slot area that the card fills. ``slots`` views ``n_slots``
    SLOT_DTYPE rows of ``backing`` (a uint8 buffer of ``n_slots + 1``
    lines: the last line holds the status words the card reports a bound
    that ran out in), or fresh zeroed numpy memory when ``backing`` is
    None. ``dev_ptr``/``status_dev_ptr`` are the card's addresses of the
    slots and the status words, None for numpy memory."""

    def __init__(self, n_slots: int, backing=None, dev_ptr: int | None = None):
        super().__init__(n_slots)
        nbytes = self.n_slots * SLOT_BYTES
        if backing is None:
            backing = np.zeros(nbytes + SLOT_BYTES, dtype=np.uint8)
        buf = np.frombuffer(backing, dtype=np.uint8,
                            count=nbytes + SLOT_BYTES)
        self.slots = buf[:nbytes].view(SLOT_DTYPE)
        self.status = buf[nbytes:].view(np.int32)
        self.dev_ptr = dev_ptr
        self.status_dev_ptr = None if dev_ptr is None else dev_ptr + nbytes
        self._free = []                  # the card allocates the slots
        # slots rung and not yet claimed: the poller rings a READY slot once
        self._rung = np.zeros(self.n_slots, dtype=bool)

    def claim_for_processing(self, slot: int) -> bool:
        with self._lock:
            ok = self._cas(slot, SlotState.READY, SlotState.PROCESSING)
            if ok:
                self._rung[slot] = False
            return ok

    def complete(self, slot: int, retval: int) -> None:
        """Write retval; FINISHED for blocking calls, FREE for non-blocking,
        which the card reuses without a host free list."""
        with self._lock:
            rec = self.slots[slot]
            rec["args"][0] = np.uint64(int(retval) & 0xFFFFFFFFFFFFFFFF)
            new = (SlotState.FINISHED if rec["flags"] & FLAG_BLOCKING
                   else SlotState.FREE)
            if not self._cas(slot, SlotState.PROCESSING, new):
                raise IllegalTransition(
                    f"slot {slot} not PROCESSING on complete")
            self._finished.notify_all()

    def in_flight(self) -> int:
        with self._lock:
            return int((self.slots["state"] != int(SlotState.FREE)).sum())

    def take_ready(self, watch: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The READY slots of ``watch`` not yet rung, split into doorbell
        slots (marked rung) and ring slots (moved to PROCESSING), each in
        the order of ``watch``."""
        states = self.slots["state"]
        ready = watch[states[watch] == int(SlotState.READY)]
        if not len(ready):
            return ready, ready
        with self._lock:
            ready = ready[(states[ready] == int(SlotState.READY))
                          & ~self._rung[ready]]
            ring = (self.slots["flags"][ready] & FLAG_RING) != 0
            bell, ring = ready[~ring], ready[ring]
            self._rung[bell] = True
            states[ring] = int(SlotState.PROCESSING)
        return bell, ring


class _Launch:
    """One launch the poller watches: rows from slot ``base`` on (``slots``,
    at most the whole area), the rows it has yet to post, and ``done()``,
    whether it has ended (a CUDA event's query)."""
    __slots__ = ("done", "base", "slots", "left")

    def __init__(self, done, base: int, slots: np.ndarray, rows: int):
        self.done, self.base, self.slots, self.left = done, base, slots, rows

    def covers(self, slots: np.ndarray, n_slots: int) -> np.ndarray:
        return (slots - self.base) % n_slots < len(self.slots)


class DevicePoller:
    """The host thread that answers the card: rings the executor for each
    READY doorbell slot and submits READY ring slots as one batch.

    ``begin(done, base, rows)`` registers a launch of ``rows`` rows from
    slot ``base`` on. The poller reads only the state words of the slots
    that outstanding launches post into, and retires a launch once it has
    taken as many rows as it posts, or once a round that began after the
    launch ended found nothing more of it (a row that ran out of its bound
    posts nothing). It parks while no launch or ring row is outstanding:
    a poller that spins takes the GIL from the caller and from the
    executor's threads."""

    SPIN_ROUNDS = 64       # empty rounds before the poller sleeps between
    MAX_SLEEP_S = 2e-4

    def __init__(self, area: DeviceSyscallArea, executor, ring: Callable,
                 device: torch.device):
        self.area = area
        self.executor = executor
        self._ring = ring                # the Genesys's lazy ring
        self._device = device
        self._cv = threading.Condition()
        self._launches: list[_Launch] = []
        self._ring_rows: list[tuple[int, object]] = []
        self._stop = False
        self.parked = False
        self.rounds = 0                  # scans
        self.n_ring = 0                  # slots submitted to the ring
        self._thread = threading.Thread(target=self._run,
                                        name="genesys-device-poller",
                                        daemon=True)
        self._thread.start()

    def begin(self, done: Callable[[], bool], base: int, rows: int) -> None:
        n = self.area.n_slots
        slots = (base + np.arange(min(rows, n))) % n
        with self._cv:
            self._launches.append(_Launch(done, base, slots, rows))
            self._cv.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._launches and not self._ring_rows,
                timeout=timeout)

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def scan(self) -> int:
        """One round: ring, submit and complete what is ready in the
        outstanding launches' slots; returns the number of slots taken.
        The bookkeeping comes before the rings, so that the executor's
        threads, woken by a ring, do not wait for the GIL behind it."""
        with self._cv:
            launches = list(self._launches)
        ended = [l for l in launches if l.done()]
        taken = 0
        if launches:
            watch = (launches[0].slots if len(launches) == 1 else
                     np.unique(np.concatenate([l.slots for l in launches])))
            bell, ring = self.area.take_ready(watch)
            taken = len(bell) + len(ring)
            gone = self._count(launches, ended,
                               np.concatenate([bell, ring]))
            for slot in bell.tolist():
                self.executor.interrupt(slot, area=self.area)
            if len(ring):
                self._submit_ring(ring)
            if gone:
                with self._cv:
                    self._launches = [l for l in self._launches
                                      if l not in gone]
                    self._cv.notify_all()
        self._finish_ring()
        self.rounds += 1
        return taken

    def _count(self, launches, ended, taken: np.ndarray) -> list:
        """Count the taken slots against the launches that post into them,
        oldest first; returns the launches with nothing left to post."""
        if len(taken):
            free = np.ones(len(taken), dtype=bool)
            for l in launches:
                if l.left:
                    hit = np.flatnonzero(
                        free & l.covers(taken, self.area.n_slots))[:l.left]
                    free[hit] = False
                    l.left -= len(hit)
        return [l for l in launches if not l.left or l in ended]

    def _submit_ring(self, slots: np.ndarray) -> None:
        recs = self.area.slots[slots]
        ring = self._ring()
        for hw in np.unique(recs["hw_id"]).tolist():
            sel = recs["hw_id"] == hw
            comps = ring.submit_np(recs["sysno"][sel].astype(np.int64),
                                   recs["args"][sel], hw_id=int(hw))
            with self._cv:
                self._ring_rows.extend(zip(slots[sel].tolist(), comps))
        self.n_ring += len(slots)

    def _finish_ring(self) -> None:
        """Write the results of the ring rows whose calls have completed
        into their slots (FINISHED, or FREE for a non-blocking row)."""
        with self._cv:
            keep, done = [], []
            for entry in self._ring_rows:
                (done if entry[1].done() else keep).append(entry)
            if not done:
                return
            self._ring_rows = keep
            for slot, comp in done:
                self.area.complete(slot, comp.result())
            self._cv.notify_all()

    def _run(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        empty = 0
        while True:
            with self._cv:
                while not (self._launches or self._ring_rows or self._stop):
                    self.parked = True
                    empty = 0
                    self._cv.wait()
                self.parked = False
                if self._stop:
                    return
            empty = 0 if self.scan() else empty + 1
            if empty > self.SPIN_ROUNDS:
                time.sleep(min(self.MAX_SLEEP_S,
                               1e-6 * (empty - self.SPIN_ROUNDS)))
            elif empty:
                time.sleep(0)


class DevicePlane:
    """Everything ``Genesys.invoke`` needs on one device: the area (mapped
    host memory on a card, numpy on the CPU), the owner words (device
    memory on a card), the poller, and a side stream for calls with no
    pre-dependency."""

    def __init__(self, gsys, device):
        self.device = torch.device(device)
        n = gsys.config.n_slots
        self._host_ptr = None
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device(
                    "cuda", torch.cuda.current_device())
            self.attributes = gi.device_attributes(self.device)
            host, dev = gi.alloc_mapped((n + 1) * SLOT_BYTES, self.device)
            self._host_ptr = host
            buf = (ctypes.c_uint8 * ((n + 1) * SLOT_BYTES)).from_address(host)
            self.area = DeviceSyscallArea(n, buf, dev_ptr=dev)
            self.owner = torch.zeros(n, dtype=torch.int32, device=self.device)
            self.side = torch.cuda.Stream(self.device)
        else:
            self.attributes = {}
            self.area = DeviceSyscallArea(n)
            self.owner = np.zeros(n, dtype=np.int32)
            self.side = None
        self.timeout_s = TIMEOUT_S
        self.poller = DevicePoller(self.area, gsys.executor,
                                   lambda: gsys.ring, self.device)
        self._lock = threading.Lock()
        self._cursor = 0
        self._events: list = []
        self._failed: str | None = None
        self._reported = False

    # -- failures ----------------------------------------------------------
    def raise_if_failed(self) -> None:
        """Raise if a bound ran out on the card (the status words live in
        mapped memory: reading them needs no sync). Sticky: the slots'
        state is then unknown, so every later call raises too."""
        if self._failed is None:
            code = int(self.area.status[0])
            if code:
                self._failed = (
                    f"device syscall slot {int(self.area.status[1])}: the "
                    f"{self.timeout_s:g} s bound ran out "
                    f"{gi.ERRORS.get(code, f'(code {code})')}")
        if self._failed is not None:
            self._reported = True
            raise TimeoutError(self._failed)

    # -- the call ------------------------------------------------------------
    def post(self, rows, *, sysno: int, flags: int, hw_id: int,
             stream=None, out=None, tag=None):
        """Launch (or, for CPU rows, run the plain version of) one call of
        ``rows`` ``[n, 6, 2]`` int32; returns the retval tensor of a
        blocking call (``out`` if given, see ``post_rows``), else None."""
        self.raise_if_failed()
        n = rows.shape[0]
        with self._lock:
            base = self._cursor
            self._cursor = (base + n) % self.area.n_slots
        kw = dict(base=base, sysno=sysno, flags=flags, hw_id=hw_id,
                  timeout_s=self.timeout_s, out=out, tag=tag)
        if rows.device.type == "cpu":
            ended = [False]
            self.poller.begin(lambda: ended[0], base, n)
            try:
                return gi.post_rows(self.area, self.owner, rows, **kw)
            finally:
                ended[0] = True
        stream = stream or torch.cuda.current_stream(self.device)
        ret = gi.post_rows(self.area, self.owner, rows, stream=stream, **kw)
        ev = torch.cuda.Event()
        ev.record(stream)
        with self._lock:
            self._events = [e for e in self._events if not e.query()]
            self._events.append(ev)
        if n:
            self.poller.begin(ev.query, base, n)
        return ret

    # -- barriers and teardown -------------------------------------------------
    def drain(self, timeout: float = 30.0) -> None:
        """Wait until every launched call has been posted and taken by the
        host (the executor's own drain then covers its processing); raise
        if a bound ran out on the card."""
        with self._lock:
            events, self._events = self._events, []
        for ev in events:
            ev.synchronize()
        self.raise_if_failed()
        if not self.poller.wait_idle(timeout):
            raise TimeoutError(
                f"drain: device calls still untaken after {timeout} s")

    def close(self) -> None:
        """Drain (unless a failure was already raised), stop the poller and
        free the mapped memory (the area keeps a copy of its slots)."""
        try:
            if not self._reported:
                self.drain()
        finally:
            if self.side is not None:
                torch.cuda.synchronize(self.device)
            self.poller.stop()
            if self._host_ptr is not None:
                self.area.slots = self.area.slots.copy()
                self.area.status = self.area.status.copy()
                gi.free_mapped(self._host_ptr)
                self._host_ptr = None

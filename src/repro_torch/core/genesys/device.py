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
* :class:`DevicePoller` is the doorbell: a host thread that watches the
  state words of the slots outstanding launches post into for READY slots
  and calls ``executor.interrupt(slot, area=...)`` for each, so the
  executor claims, dispatches and completes it as any other slot. Rows
  flagged for the ring go through ``SyscallRing.submit_np`` as one batch
  instead, and the poller writes each result back into its slot. On a
  mapped area it spins in C (``genesys_doorbell_wait``, called through a
  handle that releases the GIL) and takes the GIL only to ring, submit
  and keep its books; on a numpy area it scans in Python, the doorbell's
  plain version. It parks while no device call is outstanding.
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

    def take_ready(self, watch: np.ndarray) -> tuple[list, list]:
        """The READY slots of ``watch`` not yet rung, split into doorbell
        slots (marked rung) and ring slots (moved to PROCESSING), each in
        the order of ``watch``."""
        return self.take(watch[self.slots["state"][watch]
                               == int(SlotState.READY)])

    # up to this many slots, one at a time beats numpy's fancy indexing,
    # which costs its microseconds an operation at any size: by numpy a
    # one-row call is rung ~90 us later, one at a time a 64-row batch
    # ~100 us later (experiments/torch_invoke_latency.py, numpy_take and
    # loop_take, on an H100's host)
    SMALL = 16

    def take(self, ready: np.ndarray) -> tuple[list, list]:
        """:meth:`take_ready` of slots already read READY (the native
        doorbell's): those still READY and not yet rung, split and marked
        under the area's lock."""
        states, rung = self.slots["state"], self._rung
        if len(ready) <= self.SMALL:
            flags, bell, ring = self.slots["flags"], [], []
            with self._lock:
                for s in ready.tolist():
                    if states[s] != SlotState.READY or rung[s]:
                        continue
                    if flags[s] & FLAG_RING:
                        states[s] = int(SlotState.PROCESSING)
                        ring.append(s)
                    else:
                        rung[s] = True
                        bell.append(s)
            return bell, ring
        with self._lock:
            ready = ready[(states[ready] == int(SlotState.READY))
                          & ~rung[ready]]
            to_ring = (self.slots["flags"][ready] & FLAG_RING) != 0
            bell, ring = ready[~to_ring], ready[to_ring]
            rung[bell] = True
            states[ring] = int(SlotState.PROCESSING)
        return bell.tolist(), ring.tolist()


class _Launch:
    """One launch the poller watches: ``rows`` rows from position ``pos``
    on (slot ``pos % n_slots``; positions count every row ever posted, so
    that launches order), the rows it has yet to post, and ``done()``,
    whether it has ended (a CUDA event's query)."""
    __slots__ = ("done", "pos", "rows", "left")

    def __init__(self, done, pos: int, rows: int):
        self.done, self.pos, self.rows, self.left = done, pos, rows, rows

    def covers(self, slots: np.ndarray, n_slots: int) -> np.ndarray:
        return (slots - self.pos) % n_slots < min(self.rows, n_slots)


class DevicePoller:
    """The host thread that answers the card: rings the executor for each
    READY doorbell slot and submits READY ring slots as one batch.

    ``begin(done, pos, rows)`` registers a launch of ``rows`` rows from
    position ``pos`` on. The poller watches one window of slots, from the
    oldest outstanding launch's first to the newest's last (the whole area
    once they span it), and retires a launch once it has taken as many
    rows as it posts, or once a round that began after the launch ended
    found nothing more of it (a row that ran out of its bound posts
    nothing). It parks while no launch or ring row is outstanding.

    On a mapped area (``area.dev_ptr`` set: the card writes it) it makes
    one pass over the window in C (``genesys_doorbell_scan``, the GIL
    kept) and, if that finds nothing, waits in ``genesys_doorbell_wait``,
    which spins in C on the window's state words with the GIL released and
    returns the READY slots not yet rung; or, with nothing, once ``begin``
    bumps the generation word (a new launch to watch), ``stop`` sets the
    stop word, or SPIN_NS passes (so that launches that ended are
    retired). The native doorbell is built with the kernels; if it cannot
    be loaded, creating the poller raises. On a numpy area the poller scans the window in Python, the doorbell's
    plain version, with SPIN_ROUNDS empty rounds before it sleeps up to
    MAX_SLEEP_S between them; so does a poller with only ring rows to
    finish."""

    SPIN_ROUNDS = 64       # empty rounds before the poller sleeps between
    MAX_SLEEP_S = 2e-4
    SPIN_NS = 1_000_000    # the native doorbell's bound on one wait
    RING_SPIN_NS = 20_000  # ... while ring rows wait to be finished

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
        self._idle = False               # the last round took nothing
        self.parked = False
        self.rounds = 0                  # scans
        self.n_ring = 0                  # slots submitted to the ring
        # the words the native doorbell reads while it spins
        self._gen = np.zeros(1, dtype=np.int64)
        self._halt = np.zeros(1, dtype=np.int32)
        self.native = area.dev_ptr is not None
        if self.native:
            self._doorbell = gi.doorbell()
            self._found = np.zeros(area.n_slots, dtype=np.int32)
            self._args = (area.slots.ctypes.data, area.n_slots,
                          area._rung.ctypes.data, self._found.ctypes.data,
                          area.n_slots, self._gen.ctypes.data,
                          self._halt.ctypes.data)
        self._thread = threading.Thread(target=self._run,
                                        name="genesys-device-poller",
                                        daemon=True)
        self._thread.start()

    def begin(self, done: Callable[[], bool], pos: int, rows: int) -> None:
        with self._cv:
            self._launches.append(_Launch(done, pos, rows))
            self._gen[0] += 1
            self._cv.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._launches and not self._ring_rows,
                timeout=timeout)

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._halt[0] = 1
            self._cv.notify_all()
        self._thread.join(timeout=5)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def _window(self, launches) -> tuple[int, int]:
        """(first slot, count) of the slots the launches post into."""
        n = self.area.n_slots
        lo = min(l.pos for l in launches)
        span = max(l.pos + l.rows for l in launches) - lo
        return (0, n) if span >= n else (lo % n, span)

    def _ready(self, launches, gen: int) -> tuple[list, list]:
        """Wait for (native) or read (plain) the window's READY slots not
        yet rung; take them (:meth:`DeviceSyscallArea.take`)."""
        first, count = self._window(launches)
        if not self.native:
            n = self.area.n_slots
            return self.area.take_ready((first + np.arange(count)) % n)
        host, n, rung, found, cap, gen_p, halt = self._args
        k = self._doorbell.scan(host, n, first, count, rung, found, cap)
        if not k:
            k = self._doorbell.wait(host, n, first, count, rung, found, cap,
                                    gen_p, gen, halt,
                                    self.RING_SPIN_NS if self._ring_rows
                                    else self.SPIN_NS)
        return self.area.take(self._found[:k].copy())

    def scan(self) -> int:
        """One round: ring, submit and complete what is ready in the
        outstanding launches' slots; returns the number of slots taken.
        The bookkeeping comes before the rings, so that the executor's
        threads, woken by a ring, do not wait for the GIL behind it."""
        with self._cv:
            launches = list(self._launches)
            gen = int(self._gen[0])
        # whether a launch ended matters only after a round found nothing
        # (a CUDA query may hand the GIL to the caller's thread)
        ended = [l for l in launches if l.done()] if self._idle else []
        taken = 0
        if launches:
            bell, ring = self._ready(launches, gen)
            taken = len(bell) + len(ring)
            gone = self._count(launches, ended, bell + ring)
            for slot in bell:
                self.executor.interrupt(slot, area=self.area)
            if ring:
                self._submit_ring(np.asarray(ring))
            if gone:
                with self._cv:
                    self._launches = [l for l in self._launches
                                      if l not in gone]
                    self._cv.notify_all()
        self._idle = not taken
        self._finish_ring()
        self.rounds += 1
        return taken

    def _count(self, launches, ended, taken: list) -> list:
        """Count the taken slots against the launches that post into them,
        oldest first; returns the launches with nothing left to post."""
        if len(launches) == 1:           # the window is its slots
            launches[0].left = max(0, launches[0].left - len(taken))
        elif taken:
            taken = np.asarray(taken)
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
                spun = self.native and bool(self._launches)
            empty = 0 if self.scan() or spun else empty + 1
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
        self._pos = 0                    # rows posted, ever: slot pos % n
        self._events: dict[int, torch.cuda.Event] = {}
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
            pos = self._pos
            self._pos = pos + n
        kw = dict(base=pos % self.area.n_slots, sysno=sysno, flags=flags,
                  hw_id=hw_id, timeout_s=self.timeout_s, out=out, tag=tag)
        if rows.device.type == "cpu":
            ended = [False]
            self.poller.begin(lambda: ended[0], pos, n)
            try:
                return gi.post_rows(self.area, self.owner, rows, **kw)
            finally:
                ended[0] = True
        stream = stream or torch.cuda.current_stream(self.device)
        ret = gi.post_rows(self.area, self.owner, rows, stream=stream, **kw)
        ev = self.record(stream)
        if n:
            self.poller.begin(ev.query, pos, n)
        return ret

    def record(self, stream) -> torch.cuda.Event:
        """The plane's one event on ``stream``, recorded now. A stream
        runs in order, so it has passed a launch once it has passed the
        newest record after it: ``drain`` waits for each stream's event,
        and a launch's ``done`` is its stream's event."""
        ev = self._events.get(stream.cuda_stream)
        if ev is None:
            ev = self._events[stream.cuda_stream] = torch.cuda.Event()
        ev.record(stream)
        return ev

    def event(self, stream) -> torch.cuda.Event:
        """``stream``'s event as last recorded (see :meth:`record`)."""
        return self._events[stream.cuda_stream]

    # -- barriers and teardown -------------------------------------------------
    def drain(self, timeout: float = 30.0) -> None:
        """Wait until every launched call has been posted and taken by the
        host (the executor's own drain then covers its processing); raise
        if a bound ran out on the card."""
        for ev in list(self._events.values()):
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

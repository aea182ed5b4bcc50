"""GENESYS's invocation entry in the port (``Genesys.invoke``,
``pack_args``) against the JAX package's, on the CPU.

* The invocation semantics tests (``tests/test_genesys_semantics.py``) and
  the ring case of ``tests/test_uring.py`` run against the port's Genesys,
  eagerly on CPU tensors (the host entry).
* ``pack_args`` packs the same values as the JAX ``pack_args``, including
  negatives, the full u64 range and a 0-d tensor (the traced scalar).
* Whole calls: the same PREAD64/PWRITE64 sequences at each granularity,
  ordering and blocking go through the JAX ``invoke`` under ``jax.jit``
  and through the port's, each on its own Genesys over the same files:
  retvals, the heap's bytes, file contents, executor counters and the rule
  errors are equal (exact: no tolerance applies).
* The device entry's plain version (``post_rows_plain``: the kernel's
  writes on a ``DeviceSyscallArea`` in numpy memory) against the doorbell
  poller and the real executor: the host entry's retvals, every slot FREE
  afterwards, no free list, the poller parked when idle and joined at
  shutdown, a stalled host timing the call out.
* The native doorbell's C++ (``csrc/genesys_doorbell.cuh``, built here with
  g++) against the poller's Python scan (``DeviceSyscallArea.take_ready``)
  on the same numpy area, and its returns on the generation word, the stop
  word and its spin bound.
The kernel itself runs only on a card (``chip_smoke.py`` phase 18).
"""
import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest import for_all
from repro.core.genesys import Genesys as JaxGenesys
from repro.core.genesys import GenesysConfig as JaxConfig
from repro.core.genesys import Granularity as JaxGranularity
from repro.core.genesys import Ordering as JaxOrdering
from repro.core.genesys.invoke import pack_args as jax_pack_args
from repro_torch.core.genesys import (Genesys, GenesysConfig, Granularity,
                                      Ordering, SLOT_DTYPE, SlotState, Sys)
from repro_torch.core.genesys.area import IllegalTransition
from repro_torch.core.genesys.device import (FLAG_RING, DevicePoller,
                                            DeviceSyscallArea)
from repro_torch.core.genesys.invoke import _join64, _split64, pack_args
from repro_torch.kernels import _build
from repro_torch.kernels import genesys_invoke as gi

ROOT = Path(__file__).resolve().parents[1]
CONFIG = dict(n_workers=2, coalesce_window_us=100, coalesce_max=8)


def cpu_args(*vals):
    return pack_args(*vals, device="cpu")


@pytest.fixture()
def tgsys():
    g = Genesys(GenesysConfig(**CONFIG))
    yield g
    g.shutdown()


# ------------------------------------------------------------ coalescing ----

def test_coalescing_respects_max():
    g = Genesys(GenesysConfig(n_workers=1, coalesce_window_us=20000,
                              coalesce_max=4))
    try:
        for _ in range(10):
            g.call(Sys.CLOCK_GETTIME, 0, blocking=False)
        g.drain()
        assert max(g.executor.stats.coalesce_hist) <= 4
        assert g.executor.stats.processed == 10
    finally:
        g.shutdown()


def test_no_coalescing_when_disabled():
    g = Genesys(GenesysConfig(n_workers=1, coalesce_window_us=0,
                              coalesce_max=1))
    try:
        for _ in range(5):
            g.call(Sys.CLOCK_GETTIME, 0, blocking=False)
        g.drain()
        assert set(g.executor.stats.coalesce_hist) == {1}
        assert g.executor.stats.bundles == 5
    finally:
        g.shutdown()


def test_drain_barrier_completes_everything(tgsys, tmp_path):
    """Paper §8.3: the CPU-invoked completion function."""
    path = str(tmp_path / "drain.bin")
    ph = tgsys.heap.register_bytes(path.encode())
    fd = tgsys.call(Sys.OPEN, ph, os.O_CREAT | os.O_WRONLY, 0o644)
    data = tgsys.heap.register(np.arange(100, dtype=np.uint8))
    for i in range(20):
        tgsys.invoke(Sys.PWRITE64, cpu_args(fd, data, 100, i * 100),
                     granularity=Granularity.WORK_GROUP,
                     ordering=Ordering.RELAXED_PRODUCER, blocking=False)
    tgsys.drain()
    assert os.path.getsize(path) == 2000


# ----------------------------------------------------- invocation rules -----

def test_kernel_strong_rejected(tgsys):
    with pytest.raises(ValueError, match="deadlock"):
        tgsys.invoke(Sys.CLOCK_GETTIME, cpu_args(0),
                     granularity=Granularity.KERNEL, ordering=Ordering.STRONG)


def test_work_item_requires_strong(tgsys):
    with pytest.raises(ValueError, match="implicit strong"):
        tgsys.invoke(Sys.CLOCK_GETTIME, cpu_args(0),
                     granularity=Granularity.WORK_ITEM,
                     ordering=Ordering.RELAXED_PRODUCER)


def test_blocking_consumer_roundtrip(tgsys, tmp_path):
    path = tmp_path / "abc.bin"
    path.write_bytes(b"abcdefgh")
    ph = tgsys.heap.register_bytes(str(path).encode())
    fd = tgsys.call(Sys.OPEN, ph, os.O_RDONLY, 0)
    bh = tgsys.heap.new_buffer(8)
    x = torch.zeros(3)
    res = tgsys.invoke(Sys.PREAD64, cpu_args(fd, bh, 8, 0),
                       granularity=Granularity.WORK_GROUP,
                       ordering=Ordering.RELAXED_CONSUMER, blocking=True,
                       deps=x)
    y, n = res.tie(x + 1.0), res.ret64()
    assert int(n) == 8
    assert bytes(np.asarray(tgsys.heap.resolve(bh)).tobytes()) == b"abcdefgh"
    np.testing.assert_allclose(y.numpy(), np.ones(3))


def test_workitem_batch_one_slot_per_item(tgsys):
    before = tgsys.executor.stats.processed
    args = torch.stack([cpu_args(0)] * 5)
    out = tgsys.invoke(Sys.CLOCK_GETTIME, args,
                       granularity=Granularity.WORK_ITEM,
                       ordering=Ordering.STRONG, blocking=True).ret64()
    assert out.shape == (5,)
    tgsys.drain()
    assert tgsys.executor.stats.processed - before == 5


def test_nonblocking_producer_overlaps(tgsys, tmp_path):
    """A non-blocking producer returns before processing completes."""
    path = str(tmp_path / "big.bin")
    ph = tgsys.heap.register_bytes(path.encode())
    fd = tgsys.call(Sys.OPEN, ph, os.O_CREAT | os.O_WRONLY, 0o644)
    big = tgsys.heap.register(np.zeros(1_000_000, dtype=np.uint8))
    x = torch.ones(2)
    res = tgsys.invoke(Sys.PWRITE64, cpu_args(fd, big, 1_000_000, 0),
                       granularity=Granularity.KERNEL,
                       ordering=Ordering.RELAXED_PRODUCER, blocking=False,
                       deps=x)
    assert res.retval is None and res.tie(x * 2) is not None
    tgsys.drain()
    assert os.path.getsize(path) == 1_000_000


# ----------------------------------------------------------- packing --------

@for_all(n_cases=200)
def test_property_pack64_roundtrip(rng):
    v = int(rng.integers(-2**62, 2**62))
    lo, hi = _split64(v)
    assert np.int32(lo) == lo and np.int32(hi) == hi
    assert _join64(np.int32(lo), np.int32(hi)) == (v & 0xFFFFFFFFFFFFFFFF)


@for_all(n_cases=300)
def test_property_pack64_full_u64_range(rng):
    v = int(rng.integers(0, 2**64, dtype=np.uint64))
    lo, hi = _split64(v)
    assert -(2**31) <= lo < 2**31 and -(2**31) <= hi < 2**31
    assert _join64(lo, hi) == v


@for_all(n_cases=200)
def test_property_pack64_negative_values(rng):
    v = -int(rng.integers(1, 2**63))
    lo, hi = _split64(v)
    assert _join64(lo, hi) == v + 2**64
    assert _join64(np.int32(lo), np.int32(hi)) == v + 2**64


def test_pack64_edge_patterns():
    for v in (0, 1, -1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1,
              -2**63, 2**64 - 1, 0xDEADBEEF_CAFEBABE, 0x80000000_80000000):
        lo, hi = _split64(v)
        assert _join64(lo, hi) == (v & 0xFFFFFFFFFFFFFFFF), hex(v)


def test_pack_args_shape():
    a = cpu_args(1, 2**40, 3)
    assert a.shape == (6, 2) and a.dtype == torch.int32


def test_pack_args_values_roundtrip():
    vals = (7, 2**40 + 13, -1, 0, 2**33)
    a = cpu_args(*vals).numpy()
    for i, v in enumerate(vals):
        assert _join64(a[i, 0], a[i, 1]) == (v & 0xFFFFFFFFFFFFFFFF)
    assert (a[len(vals):] == 0).all()


def test_pack_args_batched_shapes():
    """WORK_ITEM batches stack to [n, 6, 2] and each row round-trips."""
    batch = torch.stack([cpu_args(i, 2**35 + i, -i) for i in range(5)])
    assert batch.shape == (5, 6, 2) and batch.dtype == torch.int32
    b = batch.numpy()
    for i in range(5):
        assert _join64(b[i, 0, 0], b[i, 0, 1]) == i
        assert _join64(b[i, 1, 0], b[i, 1, 1]) == 2**35 + i
        assert _join64(b[i, 2, 0], b[i, 2, 1]) == (-i & 0xFFFFFFFFFFFFFFFF)


def test_pack_args_0d_tensor():
    """A 0-d tensor packs into the lo word (the JAX traced scalar)."""
    out = cpu_args(torch.tensor(41, dtype=torch.int32), 3).numpy()
    assert out[0, 0] == 41 and out[0, 1] == 0
    assert _join64(out[1, 0], out[1, 1]) == 3


def test_pack_args_refuses_seven_args():
    with pytest.raises(ValueError, match="at most 6"):
        cpu_args(*range(7))


def _random_value(rng):
    kind = rng.integers(4)
    if kind == 0:
        return int(rng.integers(0, 2**64, dtype=np.uint64))
    if kind == 1:
        return -int(rng.integers(1, 2**63))
    if kind == 2:
        return int(rng.integers(-2**31, 2**31))
    return int(rng.choice([0, 1, -1, 2**31, 2**32 - 1, 2**63, 2**64 - 1]))


@for_all(n_cases=200)
def test_property_pack_args_equals_jax(rng):
    vals = [_random_value(rng) for _ in range(int(rng.integers(0, 7)))]
    np.testing.assert_array_equal(cpu_args(*vals).numpy(),
                                  np.asarray(jax_pack_args(*vals)))


@for_all(n_cases=50)
def test_property_pack_args_scalar_equals_jax_traced(rng):
    """A 0-d int tensor packs as the JAX package packs a traced scalar."""
    v = int(rng.integers(-2**31, 2**31))
    other = _random_value(rng)
    want = np.asarray(jax.jit(lambda s: jax_pack_args(other, s))(
        jnp.asarray(v, jnp.int32)))
    got = cpu_args(other, torch.tensor(v, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the ring ------

def test_invoke_via_ring(tgsys, tmp_path):
    """A WORK_ITEM batch routed through the ring: one SQE per row, the
    results from the futures."""
    path = tmp_path / "f.bin"
    path.write_bytes(bytes(range(64)))
    ph = tgsys.heap.register_bytes(str(path).encode())
    fd = tgsys.call(Sys.OPEN, ph, os.O_RDONLY, 0)
    bh = tgsys.heap.new_buffer(64)
    args = torch.stack([cpu_args(fd, bh, 16, 16 * i, 16 * i)
                        for i in range(4)])
    out = tgsys.invoke(Sys.PREAD64, args, granularity=Granularity.WORK_ITEM,
                       ordering=Ordering.STRONG, blocking=True,
                       via_ring=True).ret64()
    assert out.tolist() == [16] * 4
    assert bytes(np.asarray(tgsys.heap.resolve(bh)).tobytes()) == \
        bytes(range(64))
    tgsys.call(Sys.CLOSE, fd)


# ------------------------------------------- whole calls against the JAX ----

MODES = [(gran, order, blocking)
         for gran, orders in (("WORK_ITEM", ("STRONG",)),
                              ("WORK_GROUP", ("STRONG", "RELAXED_PRODUCER",
                                              "RELAXED_CONSUMER")),
                              ("KERNEL", ("RELAXED_PRODUCER",
                                          "RELAXED_CONSUMER")))
         for order in orders for blocking in (True, False)]
CHUNK, N_CHUNKS = 512, 8
COUNTERS = ("interrupts", "processed", "ring_processed")


def _jax_invoke(g, sysno, args, **kw):
    def step(x):
        res = g.invoke(sysno, args, deps=x, **kw)
        return x if res.retval is None else res.retval
    out = jax.jit(step)(jnp.zeros(1))
    return np.asarray(out) if kw["blocking"] else None


def _torch_invoke(g, sysno, args, **kw):
    res = g.invoke(sysno, args, deps=torch.zeros(1), **kw)
    return None if res.retval is None else res.retval.numpy()


def _run_sequence(g, pack, stack, invoke, src: Path, dst: Path, gran, order,
                  blocking, via_ring):
    """Read ``src`` into a heap buffer and write the buffer to ``dst`` with
    its chunks in reverse order: N_CHUNKS rows of one call at WORK_ITEM,
    else one call a chunk."""
    fd_src = g.call(Sys.OPEN, g.heap.register_bytes(str(src).encode()),
                    os.O_RDONLY, 0)
    fd_dst = g.call(Sys.OPEN, g.heap.register_bytes(str(dst).encode()),
                    os.O_CREAT | os.O_WRONLY, 0o644)
    buf = g.heap.new_buffer(CHUNK * N_CHUNKS)
    g.drain()
    before = g.executor.counters.snapshot()
    kw = dict(granularity=gran, ordering=order, blocking=blocking,
              via_ring=via_ring)
    rets = []
    for sysno, fd, place in ((Sys.PREAD64, fd_src, lambda i: i),
                             (Sys.PWRITE64, fd_dst,
                              lambda i: N_CHUNKS - 1 - i)):
        rows = [pack(fd, buf, CHUNK, CHUNK * place(i), CHUNK * i)
                for i in range(N_CHUNKS)]
        if gran.name == "WORK_ITEM":
            rets.append(invoke(g, sysno, stack(rows), **kw))
        else:
            rets.extend(invoke(g, sysno, r, **kw) for r in rows)
        g.drain()
    after = g.executor.counters.snapshot()
    g.call(Sys.CLOSE, fd_dst)
    g.call(Sys.CLOSE, fd_src)
    return (rets, np.asarray(g.heap.resolve(buf)).tobytes(), dst.read_bytes(),
            {k: after[k] - before[k] for k in COUNTERS})


@pytest.mark.parametrize("via_ring", [False, True], ids=["doorbell", "ring"])
@pytest.mark.parametrize("gran,order,blocking", MODES,
                         ids=[f"{g}-{o}-{'block' if b else 'nonblock'}"
                              for g, o, b in MODES])
def test_whole_calls_equal_jax(tmp_path, gran, order, blocking, via_ring):
    src = tmp_path / "src.bin"
    src.write_bytes(np.random.default_rng(5).integers(
        0, 256, CHUNK * N_CHUNKS, dtype=np.uint8).tobytes())
    jg, tg = JaxGenesys(JaxConfig(**CONFIG)), Genesys(GenesysConfig(**CONFIG))
    try:
        want = _run_sequence(jg, jax_pack_args, jnp.stack, _jax_invoke, src,
                             tmp_path / "jax.bin", JaxGranularity[gran],
                             JaxOrdering[order], blocking, via_ring)
        got = _run_sequence(tg, cpu_args, torch.stack, _torch_invoke, src,
                            tmp_path / "torch.bin", Granularity[gran],
                            Ordering[order], blocking, via_ring)
    finally:
        jg.shutdown()
        tg.shutdown()
    assert len(got[0]) == len(want[0])
    for g_ret, w_ret in zip(got[0], want[0]):
        if w_ret is None:
            assert g_ret is None
        else:
            np.testing.assert_array_equal(g_ret, w_ret)
    assert got[1] == want[1] == src.read_bytes()
    assert got[2] == want[2]
    assert got[3] == want[3]


RULES = [("KERNEL", "STRONG", False), ("WORK_ITEM", "RELAXED_PRODUCER", False),
         ("WORK_ITEM", "RELAXED_CONSUMER", False),
         ("WORK_GROUP", "STRONG", True), ("KERNEL", "RELAXED_CONSUMER", True)]


@pytest.mark.parametrize("gran,order,batched", RULES,
                         ids=[f"{g}-{o}-{'batch' if b else 'one'}"
                              for g, o, b in RULES])
def test_rule_errors_equal_jax(gran, order, batched):
    jg, tg = JaxGenesys(JaxConfig(**CONFIG)), Genesys(GenesysConfig(**CONFIG))
    try:
        ja, ta = jax_pack_args(0), cpu_args(0)
        if batched:
            ja, ta = jnp.stack([ja] * 3), torch.stack([ta] * 3)
        with pytest.raises(ValueError) as want:
            jg.invoke(Sys.CLOCK_GETTIME, ja,
                      granularity=JaxGranularity[gran],
                      ordering=JaxOrdering[order])
        with pytest.raises(ValueError) as got:
            tg.invoke(Sys.CLOCK_GETTIME, ta, granularity=Granularity[gran],
                      ordering=Ordering[order])
        assert str(got.value) == str(want.value)
        assert tg.executor.stats.interrupts == 0
    finally:
        jg.shutdown()
        tg.shutdown()


# ---------------------------------- the device entry's plain version -------

def _echo_rows(values):
    return torch.stack([cpu_args(v, i) for i, v in enumerate(values)])


ECHO_VALUES = [0, 1, -1, 2**31, 2**32 - 1, 2**40 + 7, -2**63, 2**64 - 1,
               0xDEADBEEF_CAFEBABE, -110]


def test_plain_device_rows_return_the_host_entrys_values(tgsys):
    plane = tgsys.device_plane("cpu")
    rows = _echo_rows(ECHO_VALUES)
    got = plane.post(rows, sysno=int(Sys.ECHO), flags=1, hw_id=3)
    want = tgsys._host_entry(True, False, np.int32(Sys.ECHO), rows.numpy(),
                             np.int32(3))
    np.testing.assert_array_equal(got.numpy(), want)
    assert [_join64(lo, hi) for lo, hi in got.tolist()] == \
        [v & 0xFFFFFFFFFFFFFFFF for v in ECHO_VALUES]
    area = plane.area
    assert (area.slots["state"] == SlotState.FREE).all()
    assert area._free == [] and area.in_flight() == 0
    assert (plane.owner == 0).all()
    assert (area.slots["hw_id"][:len(ECHO_VALUES)] == 3).all()


def test_plain_device_preads_equal_the_host_entry(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(np.random.default_rng(9).integers(
        0, 256, 4096, dtype=np.uint8).tobytes())
    out = {}
    for entry in ("device", "host"):
        g = Genesys(GenesysConfig(**CONFIG))
        try:
            fd = g.call(Sys.OPEN, g.heap.register_bytes(str(src).encode()),
                        os.O_RDONLY, 0)
            buf = g.heap.new_buffer(4096)
            rows = torch.stack([cpu_args(fd, buf, 256, 256 * i, 256 * i)
                                for i in range(16)])
            before = g.executor.stats.interrupts
            if entry == "device":
                ret = g.device_plane("cpu").post(
                    rows, sysno=int(Sys.PREAD64), flags=1, hw_id=0).numpy()
            else:
                ret = g._host_entry(True, False, np.int32(Sys.PREAD64),
                                    rows.numpy(), np.int32(0))
            g.drain()
            out[entry] = (ret, np.asarray(g.heap.resolve(buf)).tobytes(),
                          g.executor.stats.interrupts - before,
                          g.executor.stats.processed)
        finally:
            g.shutdown()
    np.testing.assert_array_equal(out["device"][0], out["host"][0])
    assert out["device"][1:] == out["host"][1:]
    assert out["device"][1] == src.read_bytes() and out["device"][2] == 16


def test_plain_device_nonblocking_rows_free_their_slots(tgsys, tmp_path):
    path = tmp_path / "nb.bin"
    fd = tgsys.call(Sys.OPEN, tgsys.heap.register_bytes(str(path).encode()),
                    os.O_CREAT | os.O_WRONLY, 0o644)
    data = tgsys.heap.register(np.arange(100, dtype=np.uint8))
    plane = tgsys.device_plane("cpu")
    rows = torch.stack([cpu_args(fd, data, 100, 100 * i) for i in range(20)])
    before = tgsys.executor.stats.processed
    assert plane.post(rows, sysno=int(Sys.PWRITE64), flags=0,
                      hw_id=0) is None
    tgsys.drain()
    assert tgsys.executor.stats.processed - before == 20
    assert os.path.getsize(path) == 2000
    assert (plane.area.slots["state"] == SlotState.FREE).all()
    assert plane.area._free == []


def test_plain_device_ring_rows_go_through_the_ring(tgsys):
    plane = tgsys.device_plane("cpu")
    before = tgsys.executor.counters.snapshot()
    got = plane.post(_echo_rows(ECHO_VALUES), sysno=int(Sys.ECHO),
                     flags=1 | FLAG_RING, hw_id=0)
    tgsys.drain()
    after = tgsys.executor.counters.snapshot()
    assert [_join64(lo, hi) for lo, hi in got.tolist()] == \
        [v & 0xFFFFFFFFFFFFFFFF for v in ECHO_VALUES]
    assert after["ring_processed"] - before["ring_processed"] == \
        len(ECHO_VALUES)
    assert after["interrupts"] == before["interrupts"]
    assert plane.poller.n_ring == len(ECHO_VALUES)
    assert (plane.area.slots["state"] == SlotState.FREE).all()


@pytest.mark.parametrize("flags", [1, 0], ids=["blocking", "nonblocking"])
def test_plain_device_rows_wrap_around_a_small_area(flags):
    """More rows than slots: a row waits for its slot to be FREE (the
    paper's delayed invocation) and every call still completes once."""
    g = Genesys(GenesysConfig(n_slots=8, **CONFIG))
    try:
        plane = g.device_plane("cpu")
        values = list(range(100, 125))
        got = plane.post(_echo_rows(values), sysno=int(Sys.ECHO),
                         flags=flags, hw_id=0)
        g.drain()
        if flags:
            assert got[:, 0].tolist() == values
        assert g.executor.stats.processed == len(values)
        assert g.executor.stats.interrupts == len(values)
        assert (plane.area.slots["state"] == SlotState.FREE).all()
    finally:
        g.shutdown()


def test_poller_parks_when_idle_and_shutdown_joins_it():
    g = Genesys(GenesysConfig(**CONFIG))
    plane = g.device_plane("cpu")
    poller = plane.poller
    plane.post(_echo_rows([5]), sysno=int(Sys.ECHO), flags=1, hw_id=0)
    deadline = time.monotonic() + 2.0
    while not poller.parked and time.monotonic() < deadline:
        time.sleep(0.005)
    assert poller.parked and poller.wait_idle(0)
    rounds = poller.rounds
    time.sleep(0.05)
    assert poller.rounds == rounds          # parked: no scans while idle
    g.shutdown()
    assert not poller.alive


def test_stalled_host_times_the_call_out(tgsys):
    plane = tgsys.device_plane("cpu")
    plane.timeout_s = 0.2
    plane.poller.stop()
    t0 = time.monotonic()
    got = plane.post(_echo_rows([7]), sysno=int(Sys.ECHO), flags=1, hw_id=0)
    waited = time.monotonic() - t0
    assert 0.2 <= waited < 2.0
    assert got.tolist() == [[-gi.ETIMEDOUT, -1]]
    assert int(plane.area.status[0]) == 3
    with pytest.raises(TimeoutError, match="bound ran out"):
        tgsys.drain()
    with pytest.raises(TimeoutError):       # sticky: nothing more posts
        plane.post(_echo_rows([8]), sysno=int(Sys.ECHO), flags=1, hw_id=0)


def test_device_area_complete_never_grows_the_free_list():
    area = DeviceSyscallArea(4)
    assert area._free == []
    for flags, final in ((0, SlotState.FREE), (1, SlotState.FINISHED)):
        area.slots["state"][2] = SlotState.READY
        area.slots["flags"][2] = flags
        assert area.claim_for_processing(2)
        area.complete(2, -5)
        assert area.state_of(2) == final and area._free == []
        assert int(area.slots["args"][2, 0]) == 2**64 - 5
        area.slots["state"][2] = SlotState.FREE
    with pytest.raises(IllegalTransition):
        area.complete(1, 0)


def test_invoke_on_cpu_args_takes_the_host_entry(tgsys):
    res = tgsys.invoke(Sys.ECHO, cpu_args(9))
    assert res.retval.tolist() == [9, 0] and tgsys._device is None


def test_wrapper_refuses_rows_it_cannot_post():
    area = DeviceSyscallArea(4)
    owner = np.zeros(4, dtype=np.int32)
    with pytest.raises(ValueError, match="int32"):
        gi.post_rows(area, owner, torch.zeros(2, 6, 2, dtype=torch.int64),
                     base=0, sysno=0, flags=1, hw_id=0, timeout_s=1.0)
    with pytest.raises(ValueError, match=r"\[n, 6, 2\]"):
        gi.post_rows(area, owner, torch.zeros(6, 2, dtype=torch.int32),
                     base=0, sysno=0, flags=1, hw_id=0, timeout_s=1.0)


def test_slot_layout_is_the_kernels():
    """csrc/genesys_protocol.cuh's Slot: sysno at 0, state at 4, args at 8,
    flags at 56, hw_id at 60; 64 bytes."""
    fields = SLOT_DTYPE.fields
    assert SLOT_DTYPE.itemsize == 64
    assert [fields[n][1] for n in ("sysno", "state", "args", "flags",
                                   "hw_id")] == [0, 4, 8, 56, 60]


def test_entry_points_match_their_ctypes_signatures():
    """Each genesys_* entry point of the CUDA source takes as many
    arguments as its ctypes signature declares."""
    src = (ROOT / "src/repro_torch/kernels/csrc/genesys_invoke.cu").read_text()
    for name, (argtypes, _) in _build.SIGNATURES.items():
        if not name.startswith("genesys_") or "error" in name:
            continue
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name


# ------------------------------------------------------ the native doorbell --

CSRC = ROOT / "src/repro_torch/kernels/csrc"
# the library's entry point (csrc/genesys_invoke.cu) over the header alone
DOORBELL_SHIM = """
#include "genesys_doorbell.cuh"
extern "C" int genesys_doorbell_scan(
    const void* host_area, int n_slots, int first, int count,
    const unsigned char* rung, int* out, int max_out) {
  return genesys::doorbell_scan(host_area, n_slots, first, count, rung, out,
                                max_out);
}
extern "C" int genesys_doorbell_wait(
    const void* host_area, int n_slots, int first, int count,
    const unsigned char* rung, int* out, int max_out,
    const long long* generation, long long seen, const int* stop,
    long long spin_ns) {
  return genesys::doorbell_wait(host_area, n_slots, first, count, rung, out,
                                max_out,
                                reinterpret_cast<const int64_t*>(generation),
                                seen, stop, spin_ns);
}
"""


@pytest.fixture(scope="module")
def doorbell_lib(tmp_path_factory) -> Path:
    """The doorbell's entry points built by g++ from the header alone."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build csrc/genesys_doorbell.cuh")
    d = tmp_path_factory.mktemp("doorbell")
    (d / "shim.cpp").write_text(DOORBELL_SHIM)
    lib = d / "libdoorbell.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                    f"-I{CSRC}", "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True)
    return lib


def _entry(lib: Path, name: str, handle=ctypes.CDLL):
    fn = getattr(handle(str(lib)), name)
    fn.argtypes, fn.restype = _build.SIGNATURES[name]
    return fn


@pytest.fixture(scope="module")
def doorbell(doorbell_lib):
    """``genesys_doorbell_wait`` through a CDLL handle (the GIL released
    while it spins)."""
    return _entry(doorbell_lib, "genesys_doorbell_wait")


def _areas(n: int, seed: int):
    """Two equal numpy areas: random states, ring flags and rung marks."""
    rng = np.random.default_rng(seed)
    states = rng.choice([SlotState.FREE, SlotState.POPULATING,
                         SlotState.READY, SlotState.PROCESSING,
                         SlotState.FINISHED], n, p=[.2, .1, .4, .2, .1])
    flags = np.where(rng.random(n) < 0.3, FLAG_RING, 0) | 1
    rung = rng.random(n) < 0.3
    areas = []
    for _ in range(2):
        a = DeviceSyscallArea(n)
        a.slots["state"] = states
        a.slots["flags"] = flags
        a._rung[:] = rung
        areas.append(a)
    return areas


def _words():
    return np.zeros(1, dtype=np.int64), np.zeros(1, dtype=np.int32)


def _wait(fn, area, first, count, gen, stop, *, seen=0, spin_ns=0):
    found = np.zeros(area.n_slots, dtype=np.int32)
    k = fn(area.slots.ctypes.data, area.n_slots, first, count,
           area._rung.ctypes.data, found.ctypes.data, area.n_slots,
           gen.ctypes.data, seen, stop.ctypes.data, spin_ns)
    return found[:k].copy()


WINDOWS = {"ready_or_not": (0, 24, 24), "already_rung": (3, 10, 24),
           "window_wraps": (21, 11, 24)}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_doorbell_header_equals_the_python_scan(doorbell, doorbell_lib,
                                               case):
    """The native doorbell (its one pass and its wait) and the Python scan
    take the same slots from the same area: the READY slots not yet rung,
    in the window's order, then split into bells (marked rung) and ring
    rows (moved to PROCESSING)."""
    first, count, n = WINDOWS[case]
    scan = _entry(doorbell_lib, "genesys_doorbell_scan", ctypes.PyDLL)
    watch = (first + np.arange(count)) % n
    skipped = 0
    for seed in range(8):
        native, plain = _areas(n, seed)
        if case == "ready_or_not":
            native._rung[:] = plain._rung[:] = False
        ready = plain.slots["state"][watch] == SlotState.READY
        skipped += int((ready & plain._rung[watch]).sum())
        gen, stop = _words()
        found = _wait(doorbell, native, first, count, gen, stop)
        np.testing.assert_array_equal(found, watch[ready
                                                   & ~plain._rung[watch]])
        once = np.zeros(n, dtype=np.int32)
        k = scan(native.slots.ctypes.data, n, first, count,
                 native._rung.ctypes.data, once.ctypes.data, n)
        np.testing.assert_array_equal(once[:k], found)
        for got, want in zip(native.take(found), plain.take_ready(watch)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(native.slots["state"],
                                      plain.slots["state"])
        np.testing.assert_array_equal(native._rung, plain._rung)
        # taken: a second pass finds nothing (bells rung, rings PROCESSING)
        assert len(_wait(doorbell, native, first, count, gen, stop)) == 0
    assert (skipped > 0) == (case != "ready_or_not")
    assert (watch < first).any() == (case == "window_wraps")


def _returns_when(doorbell, poke) -> float:
    """Seconds a wait with nothing READY and a 10 s bound takes to return
    once ``poke(gen, stop)`` runs 50 ms after it started."""
    area = DeviceSyscallArea(8)
    gen, stop = _words()
    out = []
    t0 = time.monotonic()
    th = threading.Thread(target=lambda: out.append(_wait(
        doorbell, area, 0, 8, gen, stop, spin_ns=int(10e9))))
    th.start()
    time.sleep(0.05)
    poke(gen, stop)
    th.join(timeout=5)
    assert not th.is_alive() and len(out[0]) == 0
    return time.monotonic() - t0


def test_doorbell_returns_on_the_generation_word(doorbell):
    def bump(gen, stop):
        gen[0] += 1
    assert _returns_when(doorbell, bump) < 2.0


def test_doorbell_returns_on_the_stop_word(doorbell):
    def halt(gen, stop):
        stop[0] = 1
    assert _returns_when(doorbell, halt) < 2.0


def test_doorbell_returns_what_turns_ready_while_it_spins(doorbell):
    area = DeviceSyscallArea(8)
    gen, stop = _words()
    out = []
    th = threading.Thread(target=lambda: out.append(_wait(
        doorbell, area, 6, 4, gen, stop, spin_ns=int(10e9))))
    th.start()
    time.sleep(0.02)
    area.slots["state"][1] = SlotState.READY      # in the window (6, 7, 0, 1)
    th.join(timeout=5)
    assert not th.is_alive() and out[0].tolist() == [1]


def test_doorbell_spin_is_bounded(doorbell):
    area = DeviceSyscallArea(8)
    gen, stop = _words()
    t0 = time.monotonic()
    assert len(_wait(doorbell, area, 0, 8, gen, stop,
                     spin_ns=int(20e6))) == 0
    assert 0.02 <= time.monotonic() - t0 < 2.0


def test_mapped_area_poller_raises_without_the_native_doorbell(monkeypatch):
    """A poller of a mapped area never falls back to the Python scan: if
    the doorbell's library cannot be built or loaded, creating it raises."""
    def no_library():
        raise RuntimeError("the kernel library cannot be built here")
    monkeypatch.setattr(_build, "build", no_library)
    gi.doorbell.cache_clear()
    area = DeviceSyscallArea(4, dev_ptr=1 << 40)
    try:
        with pytest.raises(RuntimeError, match="cannot be built"):
            DevicePoller(area, None, lambda: None, torch.device("cpu"))
    finally:
        gi.doorbell.cache_clear()


def test_numpy_area_poller_takes_the_python_scan(tgsys):
    assert not tgsys.device_plane("cpu").poller.native


@pytest.mark.cuda
def test_mapped_area_plane_on_the_card_takes_the_native_doorbell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mapped area lives in "
                    "cudaHostAlloc memory")
    g = Genesys(GenesysConfig(**CONFIG))
    try:
        poller = g.device_plane("cuda").poller
        assert poller.native and poller._doorbell == gi.doorbell()
        res = g.invoke(Sys.ECHO, pack_args(11, device="cuda"))
        assert res.retval.cpu().tolist() == [11, 0]
    finally:
        g.shutdown()


def _native_plane(g, doorbell_lib, monkeypatch):
    """``g``'s CPU plane with its poller replaced by one that waits in the
    g++-built doorbell (the area marked mapped; its rows still take the
    plain version, which writes the same numpy memory)."""
    plane = g.device_plane("cpu")
    plane.poller.stop()
    bell = gi.Doorbell(
        _entry(doorbell_lib, "genesys_doorbell_scan", ctypes.PyDLL),
        _entry(doorbell_lib, "genesys_doorbell_wait"))
    monkeypatch.setattr(gi, "doorbell", lambda: bell)
    plane.area.dev_ptr = 1 << 40          # never read by the plain version
    plane.poller = DevicePoller(plane.area, g.executor, lambda: g.ring,
                                torch.device("cpu"))
    assert plane.poller.native
    return plane


NATIVE_CASES = {"blocking": (1, 4096), "nonblocking": (0, 4096),
                "ring": (1 | FLAG_RING, 4096), "wrap": (1, 8)}


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_native_poller_answers_as_the_python_scan(doorbell_lib,
                                                  monkeypatch, case):
    """The poller waiting in the native doorbell answers the plain
    version's rows as the Python scan does: the values, one interrupt a
    row (none for ring rows), every slot FREE, and it parks again."""
    flags, n_slots = NATIVE_CASES[case]
    g = Genesys(GenesysConfig(n_slots=n_slots, **CONFIG))
    try:
        plane = _native_plane(g, doorbell_lib, monkeypatch)
        values = list(range(200, 225))
        before = g.executor.counters.snapshot()
        got = plane.post(_echo_rows(values), sysno=int(Sys.ECHO),
                         flags=flags, hw_id=0)
        g.drain()
        after = g.executor.counters.snapshot()
        if flags & 1:
            assert got[:, 0].tolist() == values
        ring = bool(flags & FLAG_RING)
        assert after["interrupts"] - before["interrupts"] == \
            (0 if ring else len(values))
        assert after["processed"] - before["processed"] == len(values)
        assert plane.poller.n_ring == (len(values) if ring else 0)
        assert (plane.area.slots["state"] == SlotState.FREE).all()
        deadline = time.monotonic() + 2.0
        while not plane.poller.parked and time.monotonic() < deadline:
            time.sleep(0.005)
        assert plane.poller.parked
    finally:
        g.shutdown()
    assert not plane.poller.alive

"""Where a device syscall's round trip goes: blocking calls from the card
through the port's GENESYS host plane, cut into parts by stamps on the
host and, in a stamped build, on the card.

    python3 experiments/torch_invoke_latency.py --src SRC --tag TAG
        [--stamps] [--phase18] [--reps N] [--batch-reps K] [--out DIR]

``SRC`` is a ``src`` directory: this checkout's, or a parent's unpacked
from ``git archive`` (its own ``chip_smoke.py`` beside it). For each of
chip_smoke.py phase 18's round trips (one blocking CLOCK_GETTIME at
work-item, work-group and kernel granularity, and a 64-row work-item
batch) REPS calls go through ``Genesys.invoke`` on the card, each cut by
host stamps (``time.perf_counter``): ``invoke``'s entry, the ctypes
launch's start and end, ``invoke``'s return, the executor's doorbell (the
first and the last row rung), the slot's completion and the sync's
return; the device time of the call comes from CUDA events around it, as
phase 18 takes it. The plain host entry (CPU args) is cut the same way.
Then the bare responder (``genesys_bare_respond``: the same protocol
answered in C with nothing behind it, the round trip's bound), and the
card's posting alone (the poller stopped; the host spins on the slot
until it reads READY).

``--stamps`` rebuilds a copy of SRC with GENESYS_INVOKE_STAMPS defined:
each row's thread records ``%globaltimer`` at kernel entry, owner word
taken, READY stored, FINISHED seen and exit (genesys_protocol.cuh), read
after each call; it times ``genesys_poll_reads``, the card's rate of
state-word reads over PCIe with 1 to 4096 threads reading at once; and it
keeps the exponential backoff the paced wait replaced
(``genesys_invoke_backoff_launch``), so that each call and the bare
responder also run under the old wait. A tree without the hooks gives no
card stamps. Intervals are taken within one
clock only: card parts from card stamps, host parts from host stamps.

Each call runs in turns under :func:`variants`: as built, and with one
part of the redesign taken out (the Python scan, the poller's
bookkeeping by numpy, the old wait).

``--batch-reps K`` adds a batch of 4096 work-item rows (one blocking
CLOCK_GETTIME each, as many as Fig. 5's 16 MB read posts) under every
setting, K calls each after 2 warm-up calls.

``--phase18`` also runs the tree's own ``chip_smoke.invoke_phase`` (every
check of phase 18, its round trips by events, Fig. 5's batches).

Writes OUT/invoke_<TAG>.json (OUT: build/invoke_latency unless --out).
Compare two trees only within one call on the card, in turns (parent,
change, change, parent): two calls may land on two cards. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PROTOCOL = "repro_torch/kernels/csrc/genesys_protocol.cuh"
# phase 18's round trips: (label, granularity, ordering, rows; 0 = [6, 2])
CALLS = (("work_item", "WORK_ITEM", "STRONG", 1),
         ("work_group", "WORK_GROUP", "STRONG", 0),
         ("kernel", "KERNEL", "RELAXED_CONSUMER", 0),
         ("work_item_64", "WORK_ITEM", "STRONG", 64))
# genesys_protocol.cuh's stamps, by index, and the card intervals read
N_STAMPS = 5
CARD_PARTS = {"entry_to_owner": (0, 1), "owner_to_ready": (1, 2),
              "ready_to_finished": (2, 3), "finished_to_exit": (3, 4),
              "entry_to_exit": (0, 4)}
HOST_PARTS = ("entry_to_launch", "launch", "launch_to_return",
              "return_to_ring", "ring_to_complete", "complete_to_sync",
              "total")
POLL_ROWS = (1, 32, 128, 1024, 4096)
BARE_SLOTS = 64


def stamped(src: Path, tag: str) -> Path:
    """A copy of ``src`` under build/ with GENESYS_INVOKE_STAMPS defined."""
    dst = ROOT / "build" / f"invoke_stamps_{tag}" / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    path = dst / PROTOCOL
    text = path.read_text()
    if "#pragma once\n" not in text:
        raise SystemExit(f"--stamps: no '#pragma once' in {PROTOCOL}")
    path.write_text(text.replace(
        "#pragma once\n", "#pragma once\n#define GENESYS_INVOKE_STAMPS 1\n", 1))
    return dst


def stamp_calls(obj, name: str, log: list) -> None:
    """Record the time of every call of ``obj.name`` in ``log``."""
    fn = getattr(obj, name)

    def wrapped(*args, **kw):
        log.append(time.perf_counter())
        return fn(*args, **kw)
    setattr(obj, name, wrapped)


def stamp_around(obj, name: str, enter: list, leave: list) -> None:
    """Record the times of every call of ``obj.name`` and its return."""
    fn = getattr(obj, name)

    def wrapped(*args, **kw):
        enter.append(time.perf_counter())
        try:
            return fn(*args, **kw)
        finally:
            leave.append(time.perf_counter())
    setattr(obj, name, wrapped)


def stamp_executor(g) -> dict:
    """Stamp the executor's two hops: the dispatcher handing a bundle to
    the workers (``_bundles.put``) and a worker starting the call
    (``table.dispatch``)."""
    marks = {"bundle": [], "worker": []}
    stamp_calls(g.executor._bundles, "put", marks["bundle"])
    stamp_calls(g.table, "dispatch", marks["worker"])
    return marks


# the device entry's layers and the executor's hops, cut finer (µs)
FINE_PARTS = ("to_post", "post_to_launch", "launch_to_post_return",
              "post_return_to_return", "ring_to_bundle", "bundle_to_worker",
              "worker_to_complete")


def stamp_launches(lib, pre: list, post: list) -> dict:
    """Record the times around every ctypes call of the invoke kernel's
    launch entry point (looked up on the library at each call). Returns
    the entry points a call may take: ``paced`` (the path's), and in a
    stamped build that has it ``backoff`` (the exponential backoff the
    paced wait replaced); the wrapper calls ``entries["use"]``."""
    entries = {"paced": lib.genesys_invoke_launch}
    backoff = getattr(lib, "genesys_invoke_backoff_launch", None)
    if backoff is not None:
        backoff.argtypes = entries["paced"].argtypes
        backoff.restype = entries["paced"].restype
        entries["backoff"] = backoff
    entries["use"] = entries["paced"]

    def wrapped(*args):
        pre.append(time.perf_counter())
        try:
            return entries["use"](*args)
        finally:
            post.append(time.perf_counter())
    lib.genesys_invoke_launch = wrapped
    return entries


class HostState:
    """How fast this process's host runs now (a fixed pure-Python loop)
    and which of its threads took CPU time since the last reading (from
    /proc/self/task, read only): a spinning thread or a slower host shows
    here, not in the parts."""

    def __init__(self):
        self.last: dict[str, float] = {}
        tick = os.sysconf("SC_CLK_TCK")
        self.tick = 1.0 / tick
        cpu_max = Path("/sys/fs/cgroup/cpu.max")
        self.cpus = {"affinity": len(os.sched_getaffinity(0)),
                     "cgroup_cpu_max": (cpu_max.read_text().strip()
                                        if cpu_max.exists() else None)}
        print(f"host: {self.cpus}", flush=True)

    def threads(self) -> dict[str, float]:
        names = {th.native_id: th.name for th in threading.enumerate()}
        out = {}
        for task in Path("/proc/self/task").iterdir():
            try:
                stat = (task / "stat").read_text()
            except OSError:
                continue
            name = names.get(int(task.name),
                             stat[stat.index("(") + 1:stat.rindex(")")])
            fields = stat[stat.rindex(")") + 2:].split()
            cpu = (int(fields[11]) + int(fields[12])) * self.tick
            out[f"{name}:{task.name}"] = cpu
        return out

    def read(self, label: str) -> dict:
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            sum(range(100_000))
            ts.append(time.perf_counter() - t0)
        now = self.threads()
        busy = sorted(((now[k] - self.last.get(k, 0.0), k) for k in now),
                      reverse=True)[:6]
        self.last = now
        out = {"probe_ms": 1e3 * statistics.median(ts),
               "busiest_threads_s": {k: round(v, 3) for v, k in busy}}
        print(f"host at {label}: probe {out['probe_ms']:.3f} ms; cpu s by "
              f"thread since last: {out['busiest_threads_s']}", flush=True)
        return out


def us(xs) -> float:
    return 1e6 * statistics.median(xs)


class CardStamps:
    """Reads the stamped build's invoke_stamps (None in a build without)."""

    def __init__(self, lib):
        self.fn = getattr(lib, "genesys_invoke_stamps_read", None)
        if self.fn is not None:
            self.fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            self.fn.restype = ctypes.c_int

    def read(self, rows: int) -> list | None:
        if self.fn is None:
            return None
        buf = (ctypes.c_ulonglong * (rows * N_STAMPS))()
        err = self.fn(ctypes.addressof(buf), len(buf))
        if err:
            raise RuntimeError(f"genesys_invoke_stamps_read: {err}")
        return [buf[r * N_STAMPS:(r + 1) * N_STAMPS] for r in range(rows)]


def card_parts(rows: list) -> dict:
    """µs of each CARD_PARTS interval: row 0's, the median over rows, and
    the call's span (first entry to last exit)."""
    out = {}
    for part, (i, j) in CARD_PARTS.items():
        vals = [(r[j] - r[i]) / 1e3 for r in rows]
        out[part] = vals[0]
        out[f"{part}_median_rows"] = statistics.median(vals)
    out["span"] = (max(r[4] for r in rows) - min(r[0] for r in rows)) / 1e3
    return out


class PollerTrace:
    """Times the native poller's doorbell calls (a tree with them): for
    each call of the experiment, how many one-pass scans and spinning
    waits the poller made, how long it spun, and when its first scan
    began after ``invoke`` returned."""

    def __init__(self, poller):
        self.events: list[tuple[str, float, float, int]] = []
        bell = getattr(poller, "_doorbell", None)
        if bell is None:
            return

        def timed(name, fn):
            def call(*args):
                t0 = time.perf_counter()
                k = fn(*args)
                self.events.append((name, t0, time.perf_counter(), k))
                return k
            return call
        poller._doorbell = type(bell)(timed("scan", bell.scan),
                                      timed("wait", bell.wait))

    def since(self, mark: int, t1: float) -> dict:
        ev = self.events[mark:]
        scans = [e for e in ev if e[0] == "scan"]
        waits = [e for e in ev if e[0] == "wait"]
        return {"scans": len(scans), "waits": len(waits),
                "spin_us": 1e6 * sum(e[2] - e[1] for e in waits),
                "first_scan_after_return_us":
                    1e6 * (scans[0][1] - t1) if scans else float("nan"),
                "first_scan_found": scans[0][3] if scans else 0}


def general_count(poller, launches, ended, taken) -> list:
    """``DevicePoller._count`` without its one-launch shortcut: every
    taken slot counted against the launches that cover it, by numpy (the
    parent's)."""
    if len(taken):
        taken = np.asarray(taken)
        free = np.ones(len(taken), dtype=bool)
        for l in launches:
            if l.left:
                hit = np.flatnonzero(
                    free & l.covers(taken, poller.area.n_slots))[:l.left]
                free[hit] = False
                l.left -= len(hit)
    return [l for l in launches if not l.left or l in ended]


def variants(plane, entries) -> dict:
    """The settings a tree's calls run under, in turns: ``as_built``, and
    in a tree with the native doorbell, each with one part of the redesign
    taken out: ``python_scan`` (the poller scans the mapped area in
    Python, as the parent's did); the poller's host bookkeeping as the
    parent's did it: ``numpy_take`` (``DeviceSyscallArea.take`` by numpy
    at any size, not one slot at a time up to ``SMALL``), ``loop_take``
    (one slot at a time at any size: the other side of ``SMALL``),
    ``general_count`` (no one-launch shortcut in ``_count``) and
    ``query_each_round`` (the launches' events queried every round, not
    only after an empty one); and in a stamped build ``old_wait`` (the
    card waits with the backoff)."""
    poller, area = plane.poller, plane.area
    native = getattr(poller, "native", False)

    def setting(wait="paced", scan=True, small=None, count=False,
                query=False):
        def apply():
            entries["use"] = entries[wait]
            if not native:
                return
            poller.native = scan
            area.SMALL = type(area).SMALL if small is None else small
            for name in ("_count", "scan"):
                poller.__dict__.pop(name, None)
            if count:
                poller._count = general_count.__get__(poller)
            if query:
                def scan_querying():
                    poller._idle = True
                    return type(poller).scan(poller)
                poller.scan = scan_querying
        return apply
    out = {"as_built": setting()}
    if native:
        out["python_scan"] = setting(scan=False)
        if hasattr(type(area), "SMALL"):
            out["numpy_take"] = setting(small=0)
            out["loop_take"] = setting(small=1 << 30)
            out["general_count"] = setting(count=True)
            out["query_each_round"] = setting(query=True)
        if "backoff" in entries:
            out["old_wait"] = setting(wait="backoff")
    return out


BATCH_CALL = ("work_item_4096", "WORK_ITEM", "STRONG", 4096)


def device_calls(torch, g, dev, reps: int, card: CardStamps,
                 entries: dict, pre: list, post: list,
                 batch_reps: int = 0) -> dict:
    """Phase 18's round trips on the card, cut by host (and card) stamps,
    under each of :func:`variants` in turns, each going first in turn
    (``entries``, ``pre`` and ``post``: :func:`stamp_launches`')."""
    from repro_torch.core.genesys import Granularity, Ordering, Sys
    from repro_torch.core.genesys.invoke import pack_args
    plane = g.device_plane(dev)
    rings, completes = [], []
    stamp_calls(g.executor, "interrupt", rings)
    stamp_calls(plane.area, "complete", completes)
    layers = {"post": [], "post_ret": []}
    stamp_around(plane, "post", layers["post"], layers["post_ret"])
    hops = stamp_executor(g)
    settings = variants(plane, entries)
    trace = PollerTrace(plane.poller)
    out = {"native_doorbell": bool(getattr(plane.poller, "native", False))}
    calls = CALLS + ((BATCH_CALL,) if batch_reps else ())
    for label, gran, order, n in calls:
        n_reps, warm = (batch_reps, 2) if n == BATCH_CALL[3] else (reps, 5)
        a = pack_args(0, device=dev)
        if n:
            a = a.expand(n, 6, 2).contiguous()
        rows = max(n, 1)
        host = {v: {p: [] for p in HOST_PARTS + ("first_ring_to_last_ring",)}
                for v in settings}
        cards = {v: [] for v in settings}
        dev_ms = {v: [] for v in settings}
        polls = {v: [] for v in settings}
        fine = {v: {p: [] for p in FINE_PARTS} for v in settings}
        turns = list(settings.items())
        for i in range(n_reps + warm):
            # each setting goes first in turn
            k = i % len(turns)
            for v, apply in turns[k:] + turns[:k]:
                apply()
                torch.cuda.synchronize()
                s, e = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                n_r, n_c, n_l = len(rings), len(completes), len(pre)
                mark, rounds = len(trace.events), plane.poller.rounds
                n_b, n_w = len(hops["bundle"]), len(hops["worker"])
                s.record()
                t0 = time.perf_counter()
                res = g.invoke(Sys.CLOCK_GETTIME, a,
                               granularity=Granularity[gran],
                               ordering=Ordering[order])
                t1 = time.perf_counter()
                e.record()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                if len(rings) != n_r + rows or len(completes) != n_c + rows \
                        or len(pre) != n_l + 1 \
                        or not bool((res.ret64().cpu() != 0).any()):
                    raise RuntimeError(
                        f"{label} {v} call {i}: {len(rings) - n_r} rings, "
                        f"{len(completes) - n_c} completions, retval "
                        f"{res.retval.cpu().tolist()}")
                stamps = card.read(rows)
                if i < warm:
                    continue
                ring0, ring1 = min(rings[n_r:]), max(rings[n_r:])
                done = max(completes[n_c:])
                for part, x in (("entry_to_launch", pre[-1] - t0),
                                ("launch", post[-1] - pre[-1]),
                                ("launch_to_return", t1 - post[-1]),
                                ("return_to_ring", ring0 - t1),
                                ("ring_to_complete", done - ring0),
                                ("complete_to_sync", t3 - done),
                                ("total", t3 - t0),
                                ("first_ring_to_last_ring", ring1 - ring0)):
                    host[v][part].append(x)
                dev_ms[v].append(s.elapsed_time(e))
                polls[v].append(dict(trace.since(mark, t1),
                                     rounds=plane.poller.rounds - rounds))
                bundle0 = min(hops["bundle"][n_b:])
                worker0 = min(hops["worker"][n_w:])
                first_done = min(completes[n_c:])
                for part, x in zip(FINE_PARTS, (
                        layers["post"][-1] - t0,
                        pre[-1] - layers["post"][-1],
                        layers["post_ret"][-1] - post[-1],
                        t1 - layers["post_ret"][-1],
                        bundle0 - ring0, worker0 - bundle0,
                        first_done - worker0)):
                    fine[v][part].append(x)
                if stamps is not None:
                    cards[v].append(card_parts(stamps))
        settings["as_built"]()
        out[label] = {}
        for v in settings:
            row = {"rows": rows, "device_ms": statistics.median(dev_ms[v]),
                   "host_us": {p: us(x) for p, x in host[v].items()}}
            if cards[v]:
                row["card_us"] = {p: statistics.median(c[p] for c in cards[v])
                                  for p in cards[v][0]}
            row["fine_us"] = {p: us(x) for p, x in fine[v].items()}
            print(f"{label} {v} fine (us): " + ", ".join(
                f"{p} {x:.1f}" for p, x in row["fine_us"].items()),
                flush=True)
            row["poller"] = {k: statistics.median(x[k] for x in polls[v])
                             for k in polls[v][0]}
            row["poller"]["found_at_first_scan"] = sum(
                x["first_scan_found"] > 0 for x in polls[v]) / len(polls[v])
            out[label][v] = row
            print(f"{label} {v} poller: {row['poller']}", flush=True)
            h = row["host_us"]
            print(f"{label} ({rows} rows) {v}: device {row['device_ms']:.4f} "
                  f"ms (events); host {h['total']:.1f} us = entry to launch "
                  f"{h['entry_to_launch']:.1f}, launch {h['launch']:.1f}, "
                  f"to return {h['launch_to_return']:.1f}, return to ring "
                  f"{h['return_to_ring']:.1f}, ring to complete "
                  f"{h['ring_to_complete']:.1f}, complete to sync "
                  f"{h['complete_to_sync']:.1f} (rings span "
                  f"{h['first_ring_to_last_ring']:.1f})", flush=True)
            if cards[v]:
                c = row["card_us"]
                print(f"{label} {v} card: entry to owner "
                      f"{c['entry_to_owner']:.2f} us, owner to READY "
                      f"{c['owner_to_ready']:.2f}, READY to FINISHED seen "
                      f"{c['ready_to_finished']:.2f}, FINISHED to exit "
                      f"{c['finished_to_exit']:.2f}, entry to exit "
                      f"{c['entry_to_exit']:.2f}, span {c['span']:.2f}",
                      flush=True)
    return out


def launch_path_costs(torch, dev, n: int = 2000) -> dict:
    """µs a call of each PyTorch operation the device entry's launch path
    can make, on this host (medians of 5 loops of ``n``)."""
    a = torch.zeros((6, 2), dtype=torch.int32, device=dev)
    buf = torch.empty(3, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    ev = torch.cuda.Event()
    ev.record(stream)

    def guarded(ctx):
        with ctx:
            pass
    ops = {
        "empty_x2": lambda: (torch.empty((2,), dtype=torch.int32, device=dev),
                             torch.empty((), dtype=torch.float32,
                                         device=dev)),
        "empty_x1": lambda: torch.empty(3, dtype=torch.int32, device=dev),
        "views_out_tag": lambda: (buf[:2].view((2,)),
                                  buf[2].view(torch.float32)),
        "unsqueeze_contiguous": lambda: a[None].contiguous(),
        "current_stream": lambda: torch.cuda.current_stream(dev),
        "current_device": lambda: torch.cuda.current_device(),
        "device_guard": lambda: guarded(torch.cuda.device(dev)),
        "event_new_record": lambda: torch.cuda.Event().record(stream),
        "event_rerecord": lambda: ev.record(stream),
        "event_query": lambda: ev.query(),
        "tensor_device": lambda: a.device,
        "data_ptr": lambda: a.data_ptr(),
    }
    out = {}
    for name, fn in ops.items():
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            ts.append((time.perf_counter() - t0) / n)
        out[name] = 1e6 * statistics.median(ts)
    torch.cuda.synchronize()
    print("launch path, us a call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in out.items()), flush=True)
    return out


def plain_calls(g, reps: int) -> dict:
    """The plain host entry's work-group call, cut by host stamps."""
    from repro_torch.core.genesys import Granularity, Ordering, Sys
    from repro_torch.core.genesys.invoke import pack_args
    rings, completes = [], []
    stamp_calls(g.executor, "interrupt", rings)
    stamp_calls(g.area, "complete", completes)
    hops = stamp_executor(g)
    args = pack_args(0, device="cpu")
    parts = {"to_ring": [], "ring_to_complete": [], "complete_to_return": [],
             "total": [], "ring_to_bundle": [], "bundle_to_worker": [],
             "worker_to_complete": []}
    for i in range(reps + 5):
        t0 = time.perf_counter()
        res = g.invoke(Sys.CLOCK_GETTIME, args,
                       granularity=Granularity.WORK_GROUP,
                       ordering=Ordering.STRONG)
        t3 = time.perf_counter()
        if int(res.ret64()) == 0:
            raise RuntimeError(f"plain call {i}: retval {res.retval}")
        if i < 5:
            continue
        parts["to_ring"].append(rings[-1] - t0)
        parts["ring_to_complete"].append(completes[-1] - rings[-1])
        parts["complete_to_return"].append(t3 - completes[-1])
        parts["total"].append(t3 - t0)
        parts["ring_to_bundle"].append(hops["bundle"][-1] - rings[-1])
        parts["bundle_to_worker"].append(hops["worker"][-1]
                                         - hops["bundle"][-1])
        parts["worker_to_complete"].append(completes[-1] - hops["worker"][-1])
    out = {k: us(v) for k, v in parts.items()}
    print(f"plain work_group: host {out['total']:.1f} us = to ring "
          f"{out['to_ring']:.1f}, ring to complete "
          f"{out['ring_to_complete']:.1f} (to bundle "
          f"{out['ring_to_bundle']:.1f}, to worker "
          f"{out['bundle_to_worker']:.1f}, to complete "
          f"{out['worker_to_complete']:.1f}), complete to return "
          f"{out['complete_to_return']:.1f}", flush=True)
    return out


def bare_calls(torch, dev, reps: int, card: CardStamps, lib_path,
               entries: dict) -> dict:
    """One blocking row answered by ``genesys_bare_respond`` on a thread of
    its own (a CDLL handle: the GIL released), as chip_smoke.py's
    ``bare_round_trip``: events around the call, and the card's stamps;
    with each wait of ``entries`` (:func:`stamp_launches`) in turns."""
    from repro_torch.core.genesys import Sys
    from repro_torch.core.genesys.area import SLOT_BYTES
    from repro_torch.core.genesys.device import DeviceSyscallArea
    from repro_torch.kernels import _build
    from repro_torch.kernels import genesys_invoke as gi
    respond = ctypes.CDLL(str(lib_path)).genesys_bare_respond
    respond.argtypes, respond.restype = _build.SIGNATURES[
        "genesys_bare_respond"]
    waits = [w for w in ("paced", "backoff") if w in entries]
    nbytes = (BARE_SLOTS + 1) * SLOT_BYTES
    host, dev_ptr = gi.alloc_mapped(nbytes, dev)
    ms = {w: [] for w in waits}
    cards = {w: [] for w in waits}
    try:
        area = DeviceSyscallArea(
            BARE_SLOTS, (ctypes.c_uint8 * nbytes).from_address(host),
            dev_ptr=dev_ptr)
        owner = torch.zeros(BARE_SLOTS, dtype=torch.int32, device=dev)
        rows = torch.zeros((1, 6, 2), dtype=torch.int32, device=dev)
        stop, answered = ctypes.c_int(0), ctypes.c_longlong(0)
        responder = threading.Thread(target=respond, args=(
            host, BARE_SLOTS, ctypes.byref(stop), int(120e9),
            ctypes.byref(answered)), daemon=True)
        responder.start()
        try:
            for i in range(reps + 5):
                for w in waits:
                    entries["use"] = entries[w]
                    torch.cuda.synchronize()
                    s, e = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                    s.record()
                    gi.post_rows(area, owner, rows, base=i,
                                 sysno=int(Sys.CLOCK_GETTIME), flags=1,
                                 hw_id=0, timeout_s=2.0)
                    e.record()
                    torch.cuda.synchronize()
                    if int(area.status[0]):
                        raise RuntimeError(f"bare call {i} {w}: status "
                                           f"{area.status[:2]}")
                    stamps = card.read(1)
                    if i >= 5:
                        ms[w].append(s.elapsed_time(e))
                        if stamps is not None:
                            cards[w].append(card_parts(stamps))
        finally:
            entries["use"] = entries["paced"]
            stop.value = 1
            responder.join(timeout=10)
    finally:
        gi.free_mapped(host)
    out = {}
    for w in waits:
        r = out[w] = {"device_ms": statistics.median(ms[w]),
                      "min_ms": min(ms[w])}
        if cards[w]:
            r["card_us"] = {p: statistics.median(c[p] for c in cards[w])
                            for p in cards[w][0]}
        print(f"bare responder, {w} wait: device {r['device_ms']:.4f} ms "
              f"(min {r['min_ms']:.4f})" + (
                  "" if not cards[w] else
                  f"; card READY to FINISHED seen "
                  f"{r['card_us']['ready_to_finished']:.2f} us, entry to "
                  f"exit {r['card_us']['entry_to_exit']:.2f}"), flush=True)
    return out


def copy_under_polling(torch, dev, entries: dict, mb: int = 256) -> dict:
    """Host-to-card copy rate of ``mb`` MB of pinned memory, alone and while
    4096 blocking rows wait on a private mapped area that nobody answers
    (each wait of ``entries`` in turn; the rows give up after their bound):
    what the waits' reads over PCIe leave of the link."""
    from repro_torch.core.genesys.area import SLOT_BYTES
    from repro_torch.core.genesys.device import DeviceSyscallArea
    from repro_torch.kernels import genesys_invoke as gi
    rows_n = 4096
    src = torch.empty(mb << 20, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(mb << 20, dtype=torch.uint8, device=dev)
    side = torch.cuda.Stream(dev)

    def rate(k: int = 12) -> float:
        ms = []
        for _ in range(k):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            dst.copy_(src, non_blocking=True)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        return (mb << 20) / (statistics.median(ms) / 1e3)
    out = {"alone_GBps": rate() / 1e9}
    nbytes = (rows_n + 1) * SLOT_BYTES
    for w in [w for w in ("paced", "backoff") if w in entries]:
        host, dev_ptr = gi.alloc_mapped(nbytes, dev)
        try:
            area = DeviceSyscallArea(
                rows_n, (ctypes.c_uint8 * nbytes).from_address(host),
                dev_ptr=dev_ptr)
            owner = torch.zeros(rows_n, dtype=torch.int32, device=dev)
            rows = torch.zeros((rows_n, 6, 2), dtype=torch.int32, device=dev)
            entries["use"] = entries[w]
            torch.cuda.synchronize()
            gi.post_rows(area, owner, rows, base=0, sysno=0, flags=1,
                         hw_id=0, timeout_s=1.0, stream=side)
            time.sleep(0.1)                   # every row is waiting by now
            out[f"{w}_GBps"] = rate() / 1e9
            side.synchronize()
        finally:
            entries["use"] = entries["paced"]
            gi.free_mapped(host)
    print("H2D copy of %d MB: %s" % (mb, ", ".join(
        f"{k} {v:.2f}" for k, v in out.items())), flush=True)
    return out


def posting_alone(torch, dev, reps: int) -> dict:
    """Launch to READY seen by the host, no poller running."""
    from repro_torch.core.genesys import Genesys, GenesysConfig, SlotState
    from repro_torch.core.genesys.invoke import pack_args
    g = Genesys(GenesysConfig(n_workers=1))
    try:
        plane = g.device_plane(dev)
        plane.poller.stop()
        states = plane.area.slots["state"]
        rows = pack_args(7, device=dev)[None]
        ts = []
        for i in range(reps + 5):
            torch.cuda.synchronize()
            slot = (plane._pos % plane.area.n_slots if hasattr(plane, "_pos")
                    else plane._cursor)
            t0 = time.perf_counter()
            plane.post(rows, sysno=1, flags=0, hw_id=0)
            while states[slot] != SlotState.READY:
                pass
            ts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            states[slot] = SlotState.FREE
        plane.poller._launches.clear()   # nothing was left to take
        out = {"launch_to_ready_us": us(ts[5:])}
    finally:
        g.shutdown()
    print(f"posting alone: launch to READY seen by the host "
          f"{out['launch_to_ready_us']:.1f} us", flush=True)
    return out


def poll_rate(torch, dev, lib) -> dict | None:
    """State-word reads a second over PCIe, POLL_ROWS threads each reading
    its slot back to back (a stamped build's genesys_poll_reads)."""
    from repro_torch.core.genesys.area import SLOT_BYTES
    from repro_torch.kernels import genesys_invoke as gi
    fn = getattr(lib, "genesys_poll_reads_launch", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                             ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_slots = max(POLL_ROWS)
    host, dev_ptr = gi.alloc_mapped((n_slots + 1) * SLOT_BYTES, dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {}
    try:
        stream = torch.cuda.current_stream(dev).cuda_stream
        for rows in POLL_ROWS:
            reads = max(64, 65536 // rows)
            ms = []
            for i in range(6):
                s, e = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                s.record()
                err = fn(dev_ptr, n_slots, rows, reads, sink.data_ptr(),
                         stream)
                e.record()
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"genesys_poll_reads: {err}")
                if i:
                    ms.append(s.elapsed_time(e))
            t = statistics.median(ms) / 1e3
            out[rows] = {"reads_per_s": rows * reads / t,
                         "us_per_read_per_thread": 1e6 * t / reads}
            print(f"poll reads, {rows} threads x {reads}: "
                  f"{out[rows]['reads_per_s']:.4g} reads/s, "
                  f"{out[rows]['us_per_read_per_thread']:.3f} us a read "
                  f"a thread", flush=True)
    finally:
        gi.free_mapped(host)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--stamps", action="store_true",
                    help="build with GENESYS_INVOKE_STAMPS and read the "
                         "card's stamps and its PCIe read rate")
    ap.add_argument("--phase18", action="store_true",
                    help="also run the tree's chip_smoke.invoke_phase")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--batch-reps", type=int, default=0,
                    help="also time a 4096-row work-item batch, K calls")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "invoke_latency")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_invoke_latency: no CUDA device", file=sys.stderr)
        return 2
    src = a.src.resolve()
    tree = src.parent
    if a.stamps:
        src = stamped(src, a.tag)
    sys.path[:0] = [str(src), str(tree)]
    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.kernels import _build
    lib_path = _build.build()
    lib = _build.library()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{a.tag}: {card}; src {a.src}; stamps {a.stamps}", flush=True)
    stamps = CardStamps(lib)
    pre, post = [], []
    entries = stamp_launches(lib, pre, post)
    result = {"src": str(a.src), "tag": a.tag, "card": card,
              "stamps": a.stamps, "reps": a.reps}
    host = HostState()
    result["host"] = {"cpus": host.cpus, "start": host.read("start")}
    result["launch_path"] = launch_path_costs(torch, dev)
    g = Genesys(GenesysConfig(n_workers=2))
    try:
        result["device"] = device_calls(torch, g, dev, a.reps, stamps,
                                        entries, pre, post, a.batch_reps)
        result["host"]["device_calls"] = host.read("device calls' end")
    finally:
        g.shutdown()
    g = Genesys(GenesysConfig(n_workers=2))
    try:
        result["plain"] = plain_calls(g, a.reps)
        result["host"]["plain_calls"] = host.read("plain calls' end")
    finally:
        g.shutdown()
    result["bare"] = bare_calls(torch, dev, a.reps, stamps, lib_path,
                                entries)
    result["posting"] = posting_alone(torch, dev, a.reps)
    result["copy"] = copy_under_polling(torch, dev, entries)
    if a.stamps:
        result["poll_rate"] = poll_rate(torch, dev, lib)
    if a.phase18:
        import chip_smoke as cs
        if "stamped_lib" in inspect.signature(cs.invoke_phase).parameters:
            phase = cs.invoke_phase(torch, dev, cs.stamped_invoke_build())
        else:                            # a tree from before the stamps
            phase = cs.invoke_phase(torch, dev)
        result["phase18"] = {k: phase[k] for k in (
            "round_trip", "bare_round_trip", "fig5", "fig7", "launches",
            "max_abs_err") if k in phase}
        for k in ("native_doorbell", "bare_round_trip_old_wait"):
            if k in phase:
                result["phase18"][k] = phase[k]
    a.out.mkdir(parents=True, exist_ok=True)
    (a.out / f"invoke_{a.tag}.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

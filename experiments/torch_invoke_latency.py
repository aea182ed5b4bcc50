"""Where a device syscall's round trip goes: one blocking call from the card
through the port's GENESYS host plane, timed apart.

    python3 experiments/torch_invoke_latency.py [--reps N] [--out DIR]

For each setting of the device poller (``DevicePoller.SPIN_ROUNDS``,
``MAX_SLEEP_S``), of the interpreter's switch interval and of the way
the host waits for the card (a spinning or a sleeping sync), REPS blocking
ECHO calls at work-group granularity go through ``Genesys.invoke`` on the
card, each cut by host stamps: the launch returning, the poller ringing
the executor, the executor completing the slot, and the host's sync
returning after the kernel has seen FINISHED; the device time of the call
comes from CUDA events around it. The plain host entry (CPU args) is cut
the same way. The settings run in turns, forwards then backwards.
Besides, the card's posting alone: with the poller stopped, a non-blocking
post, the host spinning on the slot's state word until it reads READY.

Prints one line a setting and writes OUT/invoke_latency.json (OUT:
build/invoke_latency unless --out). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SETTINGS = {
    "default": {},
    "no_spin": {"SPIN_ROUNDS": 0},
    "spin_only": {"SPIN_ROUNDS": 10 ** 9},
    "switch_100us": {"switchinterval": 1e-4},
    "no_spin_switch_100us": {"SPIN_ROUNDS": 0, "switchinterval": 1e-4},
    "blocking_sync": {"blocking_sync": True},
}


def stamp_calls(obj, name: str, log: list) -> None:
    """Record the time of every call of ``obj.name`` in ``log``."""
    fn = getattr(obj, name)

    def wrapped(*args, **kw):
        log.append(time.perf_counter())
        return fn(*args, **kw)
    setattr(obj, name, wrapped)


def median_ms(xs) -> float:
    return 1e3 * statistics.median(xs)


def device_calls(torch, g, plane, dev, reps: int,
                 blocking_sync: bool = False) -> dict:
    """``blocking_sync``: wait on an event that sleeps the host thread
    (cudaEventBlockingSync) instead of ``torch.cuda.synchronize``, which
    spins a core."""
    from repro_torch.core.genesys import Granularity, Ordering, Sys
    from repro_torch.core.genesys.invoke import pack_args
    rings, completes = [], []
    stamp_calls(g.executor, "interrupt", rings)
    stamp_calls(plane.area, "complete", completes)
    args = pack_args(7, device=dev)
    parts = {"launch": [], "to_ring": [], "ring_to_complete": [],
             "complete_to_sync": [], "total": []}
    dev_ms = []
    for i in range(reps + 5):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True, blocking=blocking_sync)
        n_r, n_c = len(rings), len(completes)
        s.record()
        t0 = time.perf_counter()
        res = g.invoke(Sys.ECHO, args, granularity=Granularity.WORK_GROUP,
                       ordering=Ordering.STRONG)
        t1 = time.perf_counter()
        e.record()
        if blocking_sync:
            e.synchronize()
        else:
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        if int(res.ret64()) != 7 or len(rings) != n_r + 1 \
                or len(completes) != n_c + 1:
            raise RuntimeError(f"call {i}: retval {res.retval}, "
                               f"{len(rings) - n_r} rings")
        if i < 5:
            continue
        parts["launch"].append(t1 - t0)
        parts["to_ring"].append(rings[-1] - t1)
        parts["ring_to_complete"].append(completes[-1] - rings[-1])
        parts["complete_to_sync"].append(t3 - completes[-1])
        parts["total"].append(t3 - t0)
        dev_ms.append(s.elapsed_time(e))
    out = {k: median_ms(v) for k, v in parts.items()}
    out["device_ms"] = statistics.median(dev_ms)
    return out


def plain_calls(g, reps: int) -> dict:
    from repro_torch.core.genesys import Granularity, Ordering, Sys
    from repro_torch.core.genesys.invoke import pack_args
    rings, completes = [], []
    stamp_calls(g.executor, "interrupt", rings)
    stamp_calls(g.area, "complete", completes)
    args = pack_args(7, device="cpu")
    parts = {"to_ring": [], "ring_to_complete": [], "complete_to_return": [],
             "total": []}
    for i in range(reps + 5):
        t0 = time.perf_counter()
        res = g.invoke(Sys.ECHO, args, granularity=Granularity.WORK_GROUP,
                       ordering=Ordering.STRONG)
        t3 = time.perf_counter()
        if int(res.ret64()) != 7:
            raise RuntimeError(f"plain call {i}: retval {res.retval}")
        if i < 5:
            continue
        parts["to_ring"].append(rings[-1] - t0)
        parts["ring_to_complete"].append(completes[-1] - rings[-1])
        parts["complete_to_return"].append(t3 - completes[-1])
        parts["total"].append(t3 - t0)
    return {k: median_ms(v) for k, v in parts.items()}


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
            slot = plane._cursor
            t0 = time.perf_counter()
            plane.post(rows, sysno=1, flags=0, hw_id=0)
            while states[slot] != SlotState.READY:
                pass
            ts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            states[slot] = SlotState.FREE
        plane.poller._launches.clear()   # nothing was left to take
        return {"launch_to_ready_ms": median_ms(ts[5:])}
    finally:
        g.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default=str(ROOT / "build" / "invoke_latency"))
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_invoke_latency: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.kernels import _build
    _build.library()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "reps": a.reps, "runs": []}
    base_switch = sys.getswitchinterval()
    order = list(SETTINGS) + list(reversed(SETTINGS))
    for name in order:
        setting = dict(SETTINGS[name])
        sys.setswitchinterval(setting.pop("switchinterval", base_switch))
        blocking_sync = setting.pop("blocking_sync", False)
        try:
            g = Genesys(GenesysConfig(n_workers=2))
            try:
                plane = g.device_plane(dev)
                for k, v in setting.items():
                    setattr(plane.poller, k, v)
                run = {"setting": name,
                       "device": device_calls(torch, g, plane, dev, a.reps,
                                              blocking_sync)}
            finally:
                g.shutdown()
            g = Genesys(GenesysConfig(n_workers=2))
            try:
                run["plain"] = plain_calls(g, a.reps)
            finally:
                g.shutdown()
        finally:
            sys.setswitchinterval(base_switch)
        result["runs"].append(run)
        d, p = run["device"], run["plain"]
        print(f"{name}: device {d['device_ms']:.4f} ms (events), host "
              f"{d['total']:.4f}: launch {d['launch']:.4f}, to ring "
              f"{d['to_ring']:.4f}, ring to complete "
              f"{d['ring_to_complete']:.4f}, complete to sync "
              f"{d['complete_to_sync']:.4f}; plain {p['total']:.4f}: to ring "
              f"{p['to_ring']:.4f}, ring to complete "
              f"{p['ring_to_complete']:.4f}, complete to return "
              f"{p['complete_to_return']:.4f}", flush=True)
    result["posting"] = posting_alone(torch, dev, a.reps)
    print(f"posting alone: launch to READY "
          f"{result['posting']['launch_to_ready_ms']:.4f} ms", flush=True)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "invoke_latency.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

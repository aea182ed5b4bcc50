"""Continuous UDP serving end to end through the port: datagrams arrive by
RECVFROM on the port's Genesys tenant rings, run through the port's
continuous-batching engine and a reduced starcoder2-7b (float32), and
leave by SENDTO. Every reply equals the JAX engine's continuation of the
same request on bridged weights. Also: the launcher serves the dense-cache
paths (eager and ``--batch-decode``) end to end on a reduced model."""
import dataclasses
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_api
from repro.serving.engine import make_engine as jax_engine
from repro.sharding import rules_for
from repro_torch.configs import get_config
from repro_torch.core.genesys import Genesys, GenesysConfig
from repro_torch.launch import serve as launcher
from repro_torch.serving.engine import make_engine
from repro_torch.serving.server import SHED_TOKEN, GenesysUdpServer
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(params_dtype="float32", compute_dtype="float32",
           kv_cache_dtype="float32")


def test_continuous_udp_end_to_end_matches_jax_engine(mesh11):
    jcfg = dataclasses.replace(jax_config("starcoder2-7b").reduced(), **F32)
    cfg = dataclasses.replace(get_config("starcoder2-7b").reduced(), **F32)
    params, _ = get_api(jcfg).init(jax.random.PRNGKey(2), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    rng = np.random.default_rng(12)
    reqs = [[int(rng.integers(1, 6)), 700 + i]
            + rng.integers(1, cfg.vocab_size, size=rng.integers(2, 12))
            .tolist() for i in range(5)]
    with mesh11:
        jeng = jax_engine(jcfg, rules_for(jcfg, mesh11), params, n_slots=3,
                          n_blocks=48, block_size=4)
        want = {}
        for r in reqs:
            assert jeng.admit(np.asarray(r[2:], np.int32), r[0], meta=r[1])
            want.update(dict(jeng.drain()))

    gsys = Genesys(GenesysConfig(n_workers=2, sched_pollers=2))
    try:
        eng = make_engine(cfg, tparams, n_slots=3, n_blocks=48,
                          block_size=4, gsys=gsys)
        srv = GenesysUdpServer(gsys, port=0, max_batch=4, payload=256,
                               batch_window_s=0.02, use_tenants=True)
        port = gsys.table._sockets[srv.fd].getsockname()[1]
        client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        client.bind(("127.0.0.1", 0))
        client.settimeout(20)
        th = threading.Thread(
            target=srv.serve_model_continuous,
            kwargs=dict(engine=eng, reply_port=client.getsockname()[1],
                        n_requests=len(reqs)), daemon=True)
        th.start()
        time.sleep(0.05)
        for r in reqs:
            client.sendto(np.asarray(r, np.int32).tobytes(),
                          ("127.0.0.1", port))
        got = {}
        try:
            for _ in reqs:
                data, _ = client.recvfrom(4096)
                reply = np.frombuffer(data, np.int32).tolist()
                got[reply[0]] = reply[1:]
        finally:
            client.close()
        th.join(20)
        assert not th.is_alive()
        srv.close()
    finally:
        gsys.shutdown()
    assert got == want
    assert all(len(got[r[1]]) == r[0] for r in reqs)
    assert SHED_TOKEN not in sum(got.values(), [])
    assert srv.stats.tokens_out == sum(r[0] for r in reqs)
    assert eng.stats.retired == len(reqs)
    assert eng.pool.stats.blocks_in_use == 0


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_is_bound(port: int) -> bool:
    """Whether a UDP socket of this host is bound to ``port``, read from
    the kernel's socket tables without taking the port: a probe that binds
    it races the server's own BIND for it."""
    for table in ("/proc/net/udp", "/proc/net/udp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except FileNotFoundError:
            continue
        if any(int(r.split()[1].rsplit(":", 1)[1], 16) == port
               for r in rows):
            return True
    return False


@pytest.mark.parametrize("kw", [{}, {"use_ring": True},
                                {"use_tenants": True}],
                         ids=["doorbell", "ring", "tenants"])
def test_server_refuses_a_port_that_is_taken(kw):
    """A BIND that fails (the port held by another socket) raises
    EADDRINUSE from ``GenesysUdpServer`` on each syscall path, and the
    socket it made is closed; the reference drops BIND's result and serves
    a socket bound to nothing, which no request reaches."""
    import errno

    held = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    held.bind(("127.0.0.1", 0))
    port = held.getsockname()[1]
    gsys = Genesys(GenesysConfig(n_workers=2, sched_pollers=1))
    try:
        with pytest.raises(OSError) as err:
            GenesysUdpServer(gsys, port=port, payload=64, **kw)
        assert err.value.errno == errno.EADDRINUSE
        assert not gsys.table._sockets
        assert _port_is_bound(port)
    finally:
        gsys.shutdown()
        held.close()


@pytest.mark.parametrize("flags,reqs,want_lens", [
    ([], [[3, 1, 4], [9]], [5, 5]),                        # eager, plain
    (["--per-request-tokens", "--tenants"],
     [[2, 11, 3, 1], [4, 12, 9]], [2, 4]),                 # eager, budgets
    (["--batch-decode", "--per-request-tokens"],
     [[3, 21, 5], [1, 22, 8, 2]], [3, 1]),                 # bucketed
    (["--arch", "zamba2-2.7b"], [[3, 1, 4], [9]], [5, 5]),  # the hybrid
    (["--arch", "rwkv6-3b"], [[3, 1, 4], [9]], [5, 5]),     # the SSM
], ids=["eager", "eager-budgets-tenants", "batch-decode", "hybrid", "ssm"])
def test_launcher_serves_dense_cache(flags, reqs, want_lens, capsys):
    """``python -m repro_torch.launch.serve`` without ``--continuous``:
    a dense cache of 256 positions on the CPU, two requests (each sent
    once the previous one is answered, so two poll batches), exit after
    ``--batches 2``; starcoder2-7b, or zamba2-2.7b or rwkv6-3b where the
    flags name it (the last ``--arch`` wins)."""
    port = _free_udp_port()
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.bind(("127.0.0.1", 0))
    client.settimeout(60)
    argv = ["--arch", "starcoder2-7b", "--reduced", "--device", "cpu",
            "--port", str(port), "--reply-port",
            str(client.getsockname()[1]), "--batches", "2",
            "--max-tokens", "5", *flags]
    th = threading.Thread(target=launcher.main, args=(argv,), daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    while not _port_is_bound(port):  # the server binds it once built
        assert time.monotonic() < deadline and th.is_alive()
        time.sleep(0.02)
    replies = []
    try:
        for r in reqs:
            client.sendto(np.asarray(r, np.int32).tobytes(),
                          ("127.0.0.1", port))
            data, _ = client.recvfrom(4096)
            replies.append(np.frombuffer(data, np.int32).tolist())
    finally:
        client.close()
    th.join(60)
    assert not th.is_alive()
    tagged = "--per-request-tokens" in flags
    assert [len(r) - tagged for r in replies] == want_lens
    if tagged:
        assert [r[0] for r in replies] == [q[1] for q in reqs]
    out = capsys.readouterr().out
    assert f"requests=2 batches=2 tokens={sum(want_lens)}" in out

"""Dense-cache serving through the port: ``GenesysUdpServer.serve_model``
(eager and bucketed) and ``CpuBaselineUdpServer.serve_model`` over UDP,
on the port's Genesys host plane.

The reference's serving tests (``tests/test_system.py``: one bucket with
mixed lengths, termination on idle polls, bucketed equals eager with
per-request budgets) run here with a torch decode stub; then a reduced
starcoder2-7b (float32) on bridged weights answers every request of all
three servers with exactly the JAX package's ``_greedy_decode`` tokens,
and back-to-back requests each get the tokens they get alone although
the port's serve step updates its cache in place."""
import dataclasses
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_api
from repro.serving.server import _greedy_decode as jax_greedy_decode
from repro.sharding import rules_for
from repro.train.steps import make_serve_step as jax_serve_step
from repro_torch.configs import get_config
from repro_torch.core.genesys import Genesys, GenesysConfig
from repro_torch.models import transformer
from repro_torch.serving.server import (
    CpuBaselineUdpServer, GenesysUdpServer, _greedy_decode,
)
from repro_torch.train.steps import make_serve_step
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(params_dtype="float32", compute_dtype="float32",
           kv_cache_dtype="float32")
MAX_LEN = 32        # dense cache positions of the model tests


@pytest.fixture()
def tgsys():
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    yield g
    g.shutdown()


def _fake_serve_fn(params, cache, cur, cl):
    """Deterministic decode stub: next token = 2*cur + 1 (cache ignored)."""
    return cur.reshape(-1) * 2 + 1, cache


def _chain(last, n):
    out = []
    for _ in range(n):
        last = 2 * last + 1
        out.append(last)
    return out


def _serve_requests(port, serve, reqs, *, n_replies):
    """Run ``serve(reply_port)`` on a daemon thread, send each int32
    request to ``port``, collect ``n_replies`` datagrams, and assert the
    serve loop terminated."""
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.bind(("127.0.0.1", 0))
    client.settimeout(20)
    th = threading.Thread(target=lambda: serve(client.getsockname()[1]),
                          daemon=True)
    th.start()
    time.sleep(0.05)
    for r in reqs:
        client.sendto(np.asarray(r, np.int32).tobytes(), ("127.0.0.1", port))
    replies = []
    try:
        for _ in range(n_replies):
            data, _ = client.recvfrom(4096)
            replies.append(np.frombuffer(data, np.int32).tolist())
    finally:
        client.close()
    th.join(30)
    assert not th.is_alive()       # the loop's stop conditions fired
    return replies


def _port_of(gsys, srv):
    return gsys.table._sockets[srv.fd].getsockname()[1]


# ----------------------------------------------- the reference's tests ----

def test_serve_model_mixed_prompt_lengths_one_bucket(tgsys):
    """One poll batch with three different prompt lengths AND budgets:
    the bucketed decode answers each tag with its own continuation, in a
    single bucket whose dispatch count is its longest member's budget."""
    cache = {"k": torch.zeros((1, 1))}
    srv = GenesysUdpServer(tgsys, port=0, max_batch=4, payload=256,
                           batch_window_s=0.2, use_ring=True)
    reqs = [[2, 101, 7], [3, 102, 5, 9], [1, 103, 1, 2, 3, 4]]
    replies = _serve_requests(
        _port_of(tgsys, srv),
        lambda rp: srv.serve_model(_fake_serve_fn, {}, cache, n_batches=1,
                                   reply_port=rp, max_tokens=8,
                                   batch_decode=True,
                                   per_request_tokens=True),
        reqs, n_replies=3)
    got = {r[0]: r[1:] for r in replies}
    assert got == {101: _chain(7, 2), 102: _chain(9, 3), 103: _chain(4, 1)}
    assert srv.stats.decode_buckets == 1
    assert srv.stats.decode_dispatches == 3    # longest budget bounds it
    assert srv.stats.decode_steps == 2 + 3 + 1
    srv.close()


def test_serve_model_idle_poll_termination(tgsys):
    """A lost datagram must not strand the loop: with ``n_requests``
    unmet, ``max_idle_polls`` consecutive empty polls end the serve."""
    cache = {"k": torch.zeros((1, 1))}
    srv = GenesysUdpServer(tgsys, port=0, max_batch=4, payload=256,
                           batch_window_s=0.02)
    tgsys.table._sockets[srv.fd].settimeout(0.05)   # cheap idle polls
    replies = _serve_requests(
        _port_of(tgsys, srv),
        lambda rp: srv.serve_model(_fake_serve_fn, {}, cache, n_batches=50,
                                   reply_port=rp, max_tokens=8,
                                   n_requests=2, max_idle_polls=3,
                                   per_request_tokens=True),
        [[2, 7, 11]], n_replies=1)                 # one of the two arrives
    assert replies == [[7] + _chain(11, 2)]
    assert srv.stats.requests == 1                 # exited via idle polls
    srv.close()


def test_serve_model_batch_matches_eager_per_request_budgets(tgsys):
    """batch_decode=True with per-request budgets answers every tag with
    exactly the eager path's tokens — in max(budget) dispatches instead
    of sum(budget)."""
    cache = {"k": torch.zeros((1, 1))}
    reqs = [[4, 1, 3], [2, 2, 5, 6], [3, 3, 2]]
    out = {}
    for batch in (False, True):
        srv = GenesysUdpServer(tgsys, port=0, max_batch=4, payload=256,
                               batch_window_s=0.2, use_ring=True)
        replies = _serve_requests(
            _port_of(tgsys, srv),
            lambda rp, s=srv, b=batch: s.serve_model(
                _fake_serve_fn, {}, cache, n_batches=1, reply_port=rp,
                max_tokens=8, batch_decode=b, per_request_tokens=True),
            reqs, n_replies=3)
        out[batch] = ({tuple(r) for r in replies},
                      srv.stats.decode_dispatches)
        srv.close()
    assert out[True][0] == out[False][0]
    assert out[False][1] == 4 + 2 + 3      # one dispatch per token step
    assert out[True][1] == 4               # longest member bounds the bucket


# --------------------------------------------- a reduced model, JAX vs port

@pytest.fixture(scope="module")
def model():
    """Reduced starcoder2-7b in float32: the JAX package's parameters and
    the port's, bridged from them."""
    jcfg = dataclasses.replace(jax_config("starcoder2-7b").reduced(), **F32)
    cfg = dataclasses.replace(get_config("starcoder2-7b").reduced(), **F32)
    params, _ = get_api(jcfg).init(jax.random.PRNGKey(5), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    return jcfg, cfg, params, tparams


def _jax_tokens(model, mesh11, prompts, budgets):
    """Each prompt's greedy continuation of its budget, by the JAX
    package's own ``_greedy_decode`` on its jitted dense serve step."""
    jcfg, _, params, _ = model
    serve = jax.jit(jax_serve_step(jcfg, rules_for(jcfg, mesh11)))
    cache = get_api(jcfg).init_cache(jcfg, 1, MAX_LEN)
    cl = jnp.zeros((1,), jnp.int32)
    with mesh11:
        return [jax_greedy_decode(serve, params, cache, cl,
                                  np.asarray(p, np.int32), n)
                for p, n in zip(prompts, budgets)]


def test_dense_udp_serving_matches_jax_greedy_decode(model, mesh11, tgsys):
    """Eager (tenants), bucketed (per-request budgets) and the CPU
    baseline answer every request with the JAX package's tokens."""
    _, cfg, _, tparams = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(1, 6, size=4)]
    budgets = [3, 6, 1, 5]
    want_eager = _jax_tokens(model, mesh11, prompts, [4] * len(prompts))
    want_budget = _jax_tokens(model, mesh11, prompts, budgets)
    serve = make_serve_step(cfg)
    cache = transformer.init_cache(cfg, 1, MAX_LEN, device="cpu")

    srv = GenesysUdpServer(tgsys, port=0, max_batch=4, payload=256,
                           batch_window_s=0.05, use_tenants=True)
    eager = _serve_requests(
        _port_of(tgsys, srv),
        lambda rp: srv.serve_model(serve, tparams, cache, n_batches=50,
                                   n_requests=4, reply_port=rp,
                                   max_tokens=4),
        prompts, n_replies=4)
    srv.close()
    assert sorted(eager) == sorted(want_eager)
    assert srv.stats.decode_dispatches == 4 * 4

    srv = GenesysUdpServer(tgsys, port=0, max_batch=4, payload=256,
                           batch_window_s=0.2, use_ring=True)
    tagged = [[b, 200 + i] + p
              for i, (b, p) in enumerate(zip(budgets, prompts))]
    bucketed = _serve_requests(
        _port_of(tgsys, srv),
        lambda rp: srv.serve_model(serve, tparams, cache, n_batches=50,
                                   n_requests=4, reply_port=rp,
                                   max_tokens=8, batch_decode=True,
                                   per_request_tokens=True),
        tagged, n_replies=4)
    srv.close()
    assert {r[0]: r[1:] for r in bucketed} == {
        200 + i: w for i, w in enumerate(want_budget)}

    cpu = CpuBaselineUdpServer(port=0)
    baseline = _serve_requests(
        cpu.sock.getsockname()[1],
        lambda rp: cpu.serve_model(serve, tparams, cache, n_batches=4,
                                   reply_port=rp, max_tokens=4),
        prompts, n_replies=4)
    cpu.close()
    assert sorted(baseline) == sorted(want_eager)
    assert cpu.stats.tokens_out == 16 and cpu.stats.requests == 4


def test_back_to_back_requests_get_the_tokens_they_get_alone(model):
    """The eager path starts every request from the one template cache,
    and the port's serve step writes its cache in place: each request
    decodes on a copy, so served after a longer request on the same
    cache, each gets what it gets from a fresh zero cache, and the
    template is never written."""
    _, cfg, _, tparams = model
    serve = make_serve_step(cfg)
    cl = torch.zeros((1,), dtype=torch.int32)
    first, second = np.asarray([7, 300, 41], np.int32), \
        np.asarray([12], np.int32)
    alone = [_greedy_decode(serve, tparams,
                            transformer.init_cache(cfg, 1, MAX_LEN,
                                                   device="cpu"),
                            cl, p, n) for p, n in ((first, 9), (second, 4))]
    shared = transformer.init_cache(cfg, 1, MAX_LEN, device="cpu")
    got = [_greedy_decode(serve, tparams, shared, cl, p, n)
           for p, n in ((first, 9), (second, 4))]
    assert got == alone
    assert shared["k"].abs().sum() == 0     # the template was never written

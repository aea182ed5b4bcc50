"""The port's examples on the CPU, each through its ``main``, against the
JAX package's examples where they compute the same thing:

* ``torch_memory_hints``: the RSS printed after each phase and each
  release equals what ``examples/memory_hints.py`` prints (the host plane
  is a verbatim copy), and the stencil equals the JAX example's to 1e-6;
* ``torch_serve_echo``: the continuation served over UDP equals the JAX
  package's ``serve_model`` on the same weights (reduced rwkv6-3b in f32,
  bridged by ``weights.py``);
* ``torch_train_lm``: 8 steps with checkpoints every 4, losses finite and
  falling, the resume landing on the last committed step, and PREAD64,
  PWRITE64 and MADVISE among the syscalls."""
import dataclasses
import math
import os
import re
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.core.genesys import Genesys as JaxGenesys
from repro.core.genesys import GenesysConfig as JaxGenesysConfig
from repro.models.registry import get_api as jax_api
from repro.serving.server import GenesysUdpServer as JaxUdpServer
from repro.sharding import rules_for
from repro.train.steps import make_serve_step as jax_serve_step
from repro_torch.configs import get_config
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import torch_memory_hints  # noqa: E402
import torch_serve_echo  # noqa: E402
import torch_train_lm  # noqa: E402

torch.set_num_threads(1)

RSS_LINE = re.compile(r"RSS = \d+ MB")


def test_memory_hints_prints_the_jax_examples_rss(capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, str(ROOT / "examples" /
                                              "memory_hints.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert ref.returncode == 0, ref.stderr[-2000:]
    out = torch_memory_hints.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.splitlines() == [ln for ln in ref.stdout.splitlines()
                                    if RSS_LINE.search(ln)]
    assert out["rss_mb"] == [128, 160, 40]
    assert out["released_rss_mb"] == [32, 8]


def test_memory_hints_stencil_matches_jnp():
    x = np.random.default_rng(0).standard_normal((512, 256)).astype(
        np.float32)
    want = (x + jnp.roll(x, 1, 0) + jnp.roll(x, -1, 0)) / 3.0
    got = torch_memory_hints.stencil(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def _jax_serve_echo(cfg, params):
    """The JAX example's request: ``[1, 5, 9]`` through its
    ``GenesysUdpServer.serve_model`` over UDP, 6 tokens."""
    from repro.launch.mesh import mesh_axis_kwargs

    mesh = jax.make_mesh((1, 1), ("data", "model"), **mesh_axis_kwargs(2))
    g = JaxGenesys(JaxGenesysConfig(n_workers=2))
    srv = JaxUdpServer(g, port=0, payload=512)
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        port = g.table._sockets[srv.fd].getsockname()[1]
        client.bind(("127.0.0.1", 0))
        client.settimeout(60)
        serve = jax.jit(jax_serve_step(cfg, rules_for(cfg, mesh)))
        cache = jax_api(cfg).init_cache(cfg, 1, 128)
        with mesh:
            th = threading.Thread(
                target=srv.serve_model, args=(serve, params, cache),
                kwargs=dict(n_batches=1,
                            reply_port=client.getsockname()[1],
                            max_tokens=torch_serve_echo.MAX_TOKENS),
                daemon=True)
            th.start()
            client.sendto(np.array(torch_serve_echo.PROMPT,
                                   np.int32).tobytes(), ("127.0.0.1", port))
            data, _ = client.recvfrom(512)
            th.join(60)
        assert not th.is_alive()
    finally:
        client.close()
        srv.close()
        g.shutdown()
    return np.frombuffer(data, np.int32).tolist()


def test_serve_echo_continuation_matches_jax_serve_model(capsys):
    f32 = dict(params_dtype="float32", compute_dtype="float32",
               kv_cache_dtype="float32")
    jcfg = dataclasses.replace(jax_config("rwkv6-3b").reduced(), **f32)
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(), **f32)
    params, _ = jax_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    want = _jax_serve_echo(jcfg, params)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    got = torch_serve_echo.main(["--device", "cpu"], cfg=cfg, params=tparams)
    assert got == want
    assert len(got) == torch_serve_echo.MAX_TOKENS
    printed = capsys.readouterr().out
    assert f"decoded continuation {got}" in printed
    assert "tokens_out=6" in printed


def test_train_lm_trains_checkpoints_and_resumes(capsys):
    out = torch_train_lm.main(["--steps", "8", "--ckpt-every", "4",
                               "--device", "cpu"])
    losses = out["stats"].losses
    assert len(losses) == 8 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert out["stats"].ckpts == 2 and out["committed"] == 8
    assert out["resumed_at"] == out["committed"]
    assert len(out["resume_losses"]) == torch_train_lm.RESUME_STEPS
    assert all(math.isfinite(x) for x in out["resume_losses"])
    for name in ("PREAD64", "PWRITE64", "MADVISE"):
        assert out["syscalls"].get(name, 0) > 0, name
    printed = capsys.readouterr().out
    assert "resumed at step 8" in printed and "coalescing histogram" in printed

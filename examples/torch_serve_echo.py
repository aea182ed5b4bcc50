"""Echo/decode server + client (paper §7.3) in the PyTorch port: model
tokens served over UDP with GENESYS network syscalls.

A reduced rwkv6-3b (random weights from seed 0) is served by
``GenesysUdpServer.serve_model`` on a thread: RECVFROM takes the prompt
``[1, 5, 9]``, the dense-cache decode step generates 6 greedy tokens, and
SENDTO returns them to a client socket. Runs on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_serve_echo.py [--device cpu]
"""
from __future__ import annotations

import argparse
import socket
import threading

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.genesys import Genesys, GenesysConfig
from repro_torch.models.registry import get_api
from repro_torch.serving.server import GenesysUdpServer
from repro_torch.train.steps import make_serve_step

PROMPT = (1, 5, 9)
MAX_TOKENS = 6


def main(argv=None, *, cfg=None, params=None) -> list[int]:
    """Serve one request and return its continuation. ``cfg`` and
    ``params`` replace the reduced rwkv6-3b and its seed-0 weights (tests
    serve weights bridged from the JAX package through them)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights and the cache")
    args = ap.parse_args(argv)

    cfg = cfg or get_config("rwkv6-3b").reduced()
    api = get_api(cfg)
    if params is None:
        params = api.init(cfg, seed=0, device=args.device)
    cache = api.init_cache(cfg, 1, 128, device=args.device)
    serve = make_serve_step(cfg)

    g = Genesys(GenesysConfig(n_workers=2))
    srv = GenesysUdpServer(g, port=0, payload=512)
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        port = g.table._sockets[srv.fd].getsockname()[1]
        client.bind(("127.0.0.1", 0))
        client.settimeout(60)
        th = threading.Thread(
            target=srv.serve_model, args=(serve, params, cache),
            kwargs=dict(n_batches=1, reply_port=client.getsockname()[1],
                        max_tokens=MAX_TOKENS),
            daemon=True)
        th.start()
        prompt = np.array(PROMPT, dtype=np.int32)
        client.sendto(prompt.tobytes(), ("127.0.0.1", port))
        data, _ = client.recvfrom(512)
        th.join(60)
        if th.is_alive():
            raise RuntimeError("the serve loop did not stop")
        tokens = np.frombuffer(data, dtype=np.int32).tolist()
        print(f"prompt {prompt.tolist()} -> decoded continuation {tokens}")
        print(f"server stats: {srv.stats}")
    finally:
        client.close()
        srv.close()
        g.shutdown()
    return tokens


if __name__ == "__main__":
    main()

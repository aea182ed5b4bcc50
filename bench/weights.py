"""Weights made from the seed on the device: one float32 buffer for every
leaf of a layout, filled by ``torch.randn`` in chunks of ``CHUNK``
elements, chunk ``i`` from a generator of its own seeded by (seed, i), so
that any leaf's first value can be made again later without a copy. A
normal leaf is then scaled, a "ones" or "zeros" leaf filled, and the
Mamba2 leaves take their usual draws from the same normal values through
the normal's distribution function u = Phi(z), uniform on (0, 1):
"log_uniform" (lo, hi) is log(lo + (hi - lo) u), as A_log = log U(1, 16);
"dt_bias" (lo, hi, floor) is the inverse softplus of dt = max(lo^(1 - u)
hi^u, floor), a step size log-uniform on [lo, hi].

Both sides get the same values: the program trains views of the buffer in
place, and the reference makes them again for itself."""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch

CHUNK = 1 << 28       # elements a randn call


def _chunk_seed(seed: int, i: int) -> int:
    h = hashlib.blake2b(f"{seed}:{i}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") >> 1


@dataclass
class Weights:
    """Views of one flat float32 buffer, leaf by leaf in ``layout`` order
    (``path -> tensor``); ``span[path]`` is the leaf's (start, end) in the
    buffer."""
    layout: list
    seed: int
    flat: torch.Tensor
    leaves: dict
    span: dict

    def tree(self) -> dict:
        """The leaves as nested dicts by path, the program's parameter
        tree."""
        out: dict = {}
        for path, t in self.leaves.items():
            *parents, name = path.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = t
        return out

    def initial(self, path: str) -> torch.Tensor:
        """A new tensor with the leaf's first value."""
        a, b = self.span[path]
        out = torch.empty(b - a, dtype=torch.float32, device=self.flat.device)
        for i in range(a // CHUNK, (b - 1) // CHUNK + 1):
            lo, hi = max(a, i * CHUNK), min(b, (i + 1) * CHUNK)
            out[lo - a:hi - a] = _draw(self.seed, i, self.flat.device,
                                       self.flat.numel())[lo - i * CHUNK:
                                                          hi - i * CHUNK]
        entry = next(e for e in self.layout if e[0] == path)
        _fill(out, entry)
        return out.view(entry[1])


def _draw(seed: int, i: int, device, total: int) -> torch.Tensor:
    n = min(CHUNK, total - i * CHUNK)
    g = torch.Generator(device=device)
    g.manual_seed(_chunk_seed(seed, i))
    return torch.randn(n, generator=g, dtype=torch.float32, device=device)


def _fill(t: torch.Tensor, entry) -> None:
    _, _, init, scale = entry
    if init == "normal":
        t.mul_(scale)
    elif init == "ones":
        t.fill_(1.0)
    elif init == "zeros":
        t.zero_()
    elif init == "log_uniform":
        lo, hi = scale
        t.copy_(torch.special.ndtr(t).mul_(hi - lo).add_(lo).log_())
    elif init == "dt_bias":
        lo, hi, floor = scale
        dt = torch.special.ndtr(t).mul_(math.log(hi / lo)).add_(
            math.log(lo)).exp_().clamp_(min=floor)
        t.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(f"unknown init {init!r}")


def make(layout: list, seed: int, device) -> Weights:
    """The weights of ``layout`` (``(path, shape, init, scale)`` leaves)
    from ``seed`` on ``device``."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in layout]
    total = sum(sizes)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    for i in range(-(-total // CHUNK)):
        g.manual_seed(_chunk_seed(seed, i))
        part = flat[i * CHUNK:min(total, (i + 1) * CHUNK)]
        torch.randn(part.shape, generator=g, dtype=torch.float32,
                    device=device, out=part)
    leaves, span, at = {}, {}, 0
    for entry, n in zip(layout, sizes):
        view = flat[at:at + n]
        _fill(view, entry)
        leaves[entry[0]] = view.view(entry[1])
        span[entry[0]] = (at, at + n)
        at += n
    return Weights(layout, seed, flat, leaves, span)

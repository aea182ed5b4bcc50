"""The one generator of training traffic: a token shard of documents drawn
from the seed as a mix file (``bench/traffic/<mix>.json``) describes them,
packed one after another with the configuration's end-of-document id
between them."""
from __future__ import annotations

import numpy as np


def document_lengths(rng: np.random.Generator, spec: dict,
                     total: int) -> np.ndarray:
    """Lengths of documents, heavy-tailed as ``spec`` says, enough to fill
    ``total`` tokens with one separator after each."""
    if spec["length"] != "lognormal":
        raise ValueError(f"unknown document length law {spec['length']!r}")
    lengths = []
    filled = 0
    while filled < total:
        n = rng.lognormal(np.log(spec["median"]), spec["sigma"], size=4096)
        n = np.clip(np.rint(n), spec["min"], spec["max"]).astype(np.int64)
        lengths.append(n)
        filled += int((n + 1).sum())
    return np.concatenate(lengths)


def token_shard(mix: dict, cfg: dict, seed: int) -> np.ndarray:
    """``mix["shard_tokens"]`` uint32 ids: documents of ids uniform over
    ``[0, vocab_size)``, each followed by ``eos_token_id``."""
    rng = np.random.default_rng(seed)
    total = mix["shard_tokens"]
    ids = rng.integers(0, cfg["vocab_size"], size=total, dtype=np.int64)
    ends = np.cumsum(document_lengths(rng, mix["documents"], total) + 1) - 1
    ids[ends[ends < total]] = cfg["eos_token_id"]
    return ids.astype(np.uint32)


def find_rows(shard: np.ndarray, tokens: np.ndarray,
              labels: np.ndarray) -> tuple:
    """The shard's own rows for a batch the loader gave: its first token
    row's offset in the shard, then each row r as ``shard[off + r (S + 1):
    ...]``. Returns ``(tokens, labels, differing)``: the rows from the
    shard, and how many of the batch's ids differ from them (all of them
    where no offset matches)."""
    R, S = tokens.shape
    n = R * (S + 1)
    head = tokens[0, :min(8, S)].astype(np.uint32)
    for off in np.flatnonzero(shard[:len(shard) - n + 1] == head[0]):
        if np.array_equal(shard[off:off + len(head)], head):
            arr = shard[off:off + n].astype(np.int64).reshape(R, S + 1)
            differ = int((arr[:, :-1] != tokens).sum()
                         + (arr[:, 1:] != labels).sum())
            return arr[:, :-1], arr[:, 1:], differ
    return tokens.astype(np.int64), labels.astype(np.int64), 2 * tokens.size

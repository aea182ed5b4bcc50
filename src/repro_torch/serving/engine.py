"""Continuous-batching decode engine over the genesys.pagedkv pool (the
PyTorch port of ``repro.serving.engine``; the arenas are torch tensors on
the device, updated in place by the step).

The closed-batch path (``serve_model(batch_decode=True)``) only batches
requests that arrive in the same poll and holds the bucket's shape until
its LONGEST request finishes — late arrivals wait, early finishers pad.
This engine decodes at one FIXED padded batch shape forever:

  * ``n_slots`` decode slots; a request occupies one slot from admission
    to retirement. Admission and retirement happen **mid-decode** — they
    mutate only a slot's block-table row, ``cache_len`` and current
    token, never an array shape (the reference relies on this to jit
    ``train.steps.make_paged_serve_step`` exactly once; here it keeps
    the decode kernels' shapes fixed).
  * Inactive slots are masked by construction: their block-table rows
    are all null-block, their ``cache_len`` is 0, and their outputs are
    never read — no `where`-masking inside the step function needed.
  * KV lives in the paged arena; a slot's prompt prefix can start
    mid-cache when :class:`~repro_torch.serving.pagedkv.PagedKVPool` has the
    prefix's blocks sealed (shared-prefix reuse skips those prefill
    steps entirely).

Prompts are consumed by teacher forcing, one token per step (prefill and
decode share the single-token step function): feeding prompt[i] writes
its KV at the slot's ``cache_len``; the step that feeds the LAST prompt
token produces the first generated token. Each generated token is fed
back until the request's budget is reached; the final token is returned
but never fed (its KV would be dead).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.genesys.trace import EV_STEP, Counters
from repro_torch.serving.pagedkv import NULL_BLOCK, PagedKVPool, PoolExhausted


@dataclass
class EngineStats:
    admitted: int = 0
    retired: int = 0
    steps: int = 0               # serve_fn dispatches
    step_slots: int = 0          # sum of active slots over steps
    prefill_steps: int = 0       # prompt tokens fed
    prefill_steps_saved: int = 0  # prompt tokens skipped via prefix reuse

    def occupancy(self) -> float:
        return self.step_slots / max(1, self.steps)


@dataclass
class _Slot:
    meta: object = None
    prompt: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    feed_idx: int = 0
    budget: int = 0
    gen: list = field(default_factory=list)
    blocks: list = field(default_factory=list)
    cache_len: int = 0
    span: int = 0                 # request-scoped trace span id (0 = none)


class ContinuousBatchEngine:
    """Slot-scheduled continuous batching over a paged KV arena."""

    def __init__(self, serve_step, params, arenas, pool: PagedKVPool, *,
                 n_slots: int, max_blocks_per_seq: int, stats=None):
        self.serve_step = serve_step
        self.params = params
        self.arenas = arenas          # {k,v: [L,NB,BS,KV,hd]}, in place
        self.pool = pool
        self.n_slots = int(n_slots)
        self.max_blocks = int(max_blocks_per_seq)
        self.block_size = pool.block_size
        if arenas["k"].shape[1] != pool.n_blocks:
            raise ValueError("arena/pool block-count mismatch")
        if arenas["k"].shape[2] != pool.block_size:
            raise ValueError("arena/pool block-size mismatch")
        # fixed-shape schedule state: one row per slot, shapes NEVER change
        self._bt = np.zeros((self.n_slots, self.max_blocks), np.int32)
        self._cl = np.zeros((self.n_slots,), np.int32)
        self._cur = np.zeros((self.n_slots, 1), np.int32)
        self._slots: list[_Slot | None] = [None] * self.n_slots
        # trace.Counters fold: telemetry snapshots of engine stats are
        # torn-read-free even while the decode loop runs (attach_stats)
        self.counters = Counters(EngineStats())
        if stats is not None and not isinstance(stats, Counters):
            stats = Counters(stats)
        self.serve_stats = stats      # optional server-side Counters
        # request-scoped tracing: the server sets this TraceChannel; each
        # decode dispatch records one EV_STEP per active span, and
        # retirement syscalls run under the request's span context
        self.trace = None
        # optional genesys.admit AdmissionController: admission failures
        # for want of capacity nudge its shed level up (note_pressure) —
        # a leading overload signal, ahead of SLO burn confirming it
        self.admission = None
        self._step_idx = 0
        # wire the pool's eviction spill to the device arenas
        pool.extractor = self._extract_block

    @property
    def stats(self) -> EngineStats:
        return self.counters.stats

    @stats.setter
    def stats(self, new) -> None:
        # benchmarks reset via ``eng.stats = EngineStats()``; swapping the
        # wrapped object under the lock keeps every attached reference
        # (telemetry, collectors) reading the live record
        with self.counters.lock:
            self.counters.stats = new

    # ------------------------------------------------------- introspection --
    @property
    def n_active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def free_slots(self) -> int:
        return self.n_slots - self.n_active

    # --------------------------------------------------- arena <-> bytes ----
    def block_bytes(self) -> int:
        k = self.arenas["k"]
        return 2 * k.numel() // k.shape[1] * k.element_size()

    # A block's payload is its k then v bytes, [L, BS, KV, hd] each in the
    # arena dtype, exactly as the reference lays them out. numpy has no
    # bf16, so the bytes travel as uint8 views of the tensors.
    def _extract_block(self, bid: int) -> bytes:
        k = self.arenas["k"][:, bid].contiguous().view(torch.uint8)
        v = self.arenas["v"][:, bid].contiguous().view(torch.uint8)
        return k.cpu().numpy().tobytes() + v.cpu().numpy().tobytes()

    def _install_block(self, bid: int, payload: bytes) -> None:
        k = self.arenas["k"]
        shape = (k.shape[0],) + tuple(k.shape[2:])
        half = len(payload) // 2
        raw = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        for name, part in (("k", raw[:half]), ("v", raw[half:])):
            self.arenas[name][:, bid].copy_(
                part.to(k.device).view(k.dtype).reshape(shape))

    # ----------------------------------------------------------- admission --
    def admit(self, prompt, n_tokens: int, meta=None,
              span: int = 0) -> bool:
        """Claim a slot for a request mid-decode. Returns False (admitting
        nothing) when no slot or not enough arena blocks are available —
        the caller keeps the request queued and retries after retirements.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n, budget = len(prompt), max(1, int(n_tokens))
        if n < 1:
            return False
        total_pos = n + budget - 1          # KV positions this request writes
        bs = self.block_size
        n_blocks = -(-total_pos // bs)
        if n_blocks > self.max_blocks:
            raise ValueError(
                f"request needs {n_blocks} blocks > table width "
                f"{self.max_blocks}")
        slot = next((i for i, s in enumerate(self._slots) if s is None), None)
        if slot is None:
            if self.admission is not None:
                self.admission.note_pressure()
            return False
        # prefix reuse: only WHOLE blocks strictly before the last prompt
        # token (at least one token must remain to feed, and writes must
        # never land inside a shared block)
        reuse_span = ((n - 1) // bs) * bs
        reused, fetches = self.pool.acquire_prefix(prompt[:reuse_span])
        try:
            fresh = self.pool.alloc(n_blocks - len(reused))
        except PoolExhausted:
            self.pool.retire(reused)        # sealed blocks re-park in LRU
            if self.admission is not None:
                self.admission.note_pressure()
            return False
        for bid, payload in fetches:
            self._install_block(bid, payload)
        blocks = reused + fresh
        r = len(reused) * bs                # cache positions already filled
        st = _Slot(meta=meta, prompt=prompt, feed_idx=r + 1, budget=budget,
                   blocks=blocks, cache_len=r, span=span)
        self._slots[slot] = st
        self._bt[slot, :] = NULL_BLOCK
        self._bt[slot, :len(blocks)] = blocks
        self._cl[slot] = r
        self._cur[slot, 0] = prompt[r]
        self.counters.add(admitted=1, prefill_steps_saved=r)
        return True

    def _retire(self, slot: int, st: _Slot) -> None:
        ch = self.trace
        if ch is not None and st.span:
            # retirement syscalls (MADVISE frees, spill PWRITE64s) are
            # attributed to the request that caused them
            with ch.tracer.span(st.span):
                self.pool.retire(st.blocks, prompt_tokens=st.prompt)
        else:
            self.pool.retire(st.blocks, prompt_tokens=st.prompt)
        self._slots[slot] = None
        self._bt[slot, :] = NULL_BLOCK
        self._cl[slot] = 0
        self._cur[slot, 0] = 0
        self.counters.add(retired=1)

    # ---------------------------------------------------------- decoding ----
    def step(self) -> list[tuple[object, list[int]]]:
        """One fixed-shape decode dispatch for every slot; advances each
        active slot through prefill or generation and retires finished
        requests. Returns the ``(meta, generated_tokens)`` pairs that
        completed on this step."""
        active = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return []
        t0 = time.perf_counter_ns()
        dev = self.arenas["k"].device
        nxt, self.arenas = self.serve_step(
            self.params, self.arenas, torch.from_numpy(self._bt).to(dev),
            torch.from_numpy(self._cur).to(dev),
            torch.from_numpy(self._cl).to(dev))
        nxt = nxt.cpu().numpy()
        dur = time.perf_counter_ns() - t0
        self.counters.add(steps=1, step_slots=len(active))
        if self.serve_stats is not None:
            self.serve_stats.add(decode_dispatches=1,
                                 decode_steps=len(active))
        ch = self.trace
        if ch is not None:
            # one self-contained EV_STEP per active request span: ts is
            # the dispatch start, aux the duration (ns) — no begin/end
            # pair to join, since a span repeats its seq across steps
            spans = [s.span for _, s in active if s.span]
            if spans:
                ch.rec_block(EV_STEP, self._step_idx, spans, aux=dur,
                             ts=t0, own=True)
        self._step_idx += 1
        finished = []
        prefills = 0
        for i, st in active:
            st.cache_len += 1               # the fed token's KV landed
            if st.feed_idx < len(st.prompt):
                # still consuming the prompt (teacher forcing)
                self._cur[i, 0] = st.prompt[st.feed_idx]
                st.feed_idx += 1
                prefills += 1
            else:
                st.gen.append(int(nxt[i]))
                if len(st.gen) >= st.budget:
                    finished.append((st.meta, st.gen))
                    self._retire(i, st)
                    continue
                self._cur[i, 0] = st.gen[-1]
            self._cl[i] = st.cache_len
        if prefills:
            self.counters.add(prefill_steps=prefills)
        return finished

    def drain(self) -> list[tuple[object, list[int]]]:
        """Run steps until every active request has retired."""
        out = []
        while self.n_active:
            out.extend(self.step())
        return out


def make_engine(cfg, params, *, n_slots: int, n_blocks: int,
                block_size: int, max_blocks_per_seq: int | None = None,
                gsys=None, spill_path: str | None = None, stats=None):
    """Build the paged pool, device arenas and the paged serve step into a
    ready :class:`ContinuousBatchEngine`. With ``gsys`` the pool's blocks
    are carved through genesys (mmap/touch/madvise residency, and — given
    ``spill_path`` — PWRITE64 spill + PREAD64_FIXED revival).

    The arenas go on the device of ``params``, and the step attends with
    the CUDA kernel wrapper (its plain version on CPU tensors). One device,
    so the reference's sharding ``rules`` and ``jit`` flag have no
    counterpart."""
    from repro_torch.models import transformer
    from repro_torch.train.steps import make_paged_serve_step

    arenas = transformer.init_paged_arena(cfg, n_blocks, block_size,
                                          device=params["embed"].device)
    pool = PagedKVPool(n_blocks, block_size)
    step = make_paged_serve_step(cfg)
    eng = ContinuousBatchEngine(
        step, params, arenas, pool, n_slots=n_slots,
        max_blocks_per_seq=max_blocks_per_seq or n_blocks // 2,
        stats=stats)
    if gsys is not None:
        pool.bind_genesys(gsys, block_bytes=eng.block_bytes(),
                          spill_path=spill_path)
        gsys.attach_stats("engine", eng.counters)
    return eng

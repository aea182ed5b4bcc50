"""genesys.fuse: cross-call semantic coalescing of popped ring bundles.

The paper's biggest throughput lever is coalescing (§6, Fig 7): aggregate
per-work-item syscalls into fewer, larger kernel crossings. The executor
already reproduces the paper's *interrupt* coalescing (N doorbells -> one
worker bundle), but every member of that bundle still dispatches as its
own host syscall. This module goes one step further — GPUstore-style
*request merging* — by fusing the calls themselves:

  * **read-range fusion** — adjacent/overlapping ``PREAD64`` /
    ``PREAD64_FIXED`` ranges on the same fd become ONE large pread into a
    scratch buffer; the bytes are scattered back to each member's own
    destination buffer and each member's retval is reconstructed exactly —
    a short read (EOF inside the merged span) splits across members
    precisely as the unfused calls would have returned. When the data
    plane is the registered arena, the scratch is an arena extent (the
    merged pread lands via ``preadv``, zero-copy) and the scatter-back is
    ONE vectorized fancy-index store per backing segment instead of a
    per-member python copy loop (:func:`scatter_read_group`);
  * **read dedup** — identical concurrent ranges collapse into the
    merged span for free (they are, by definition, overlapping), so N
    readers of one hot block cost one kernel crossing;
  * **write-range fusion** — strictly adjacent ``PWRITE64`` /
    ``PWRITE64_FIXED`` ranges on the same fd gather into one scratch
    extent and issue as ONE pwrite (the gather-side fusion the sharded-
    checkpoint roadmap item needed). Write ordering rules are explicit
    and conservative: two writes on the same fd whose ranges overlap
    anywhere NEVER merge (the result is submission-order-dependent;
    every write on that fd passes through serially), gaps split runs,
    and writes never fuse when the same bundle reads/plain-writes/closes
    that fd;
  * **mmap batching** — same-size-class ``MMAP`` allocations in one
    bundle are carved by :meth:`MemoryPool.mmap_many` under a single pool
    lock round, one address per member.

Everything else passes through untouched, in submission order.

Semantics: fusion is only legal under the paper's *weak ordering* (§8.3
— exactly what ring submissions are): members of a fused group complete
together, so intra-bundle completion order is not submission order.
Retvals and destination-buffer contents are bit-exact with the unfused
path (property-tested against an oracle in tests/test_fuse.py and
tests/test_arena.py): the scatter writes members in submission order
(aliased destinations keep last-write-wins — the vectorized store is
only taken when destinations are disjoint, because numpy's duplicate-
index assignment order is unspecified), and reads/writes on an fd the
same bundle also closes/writes/reads are excluded from fusion so they
keep their serial position. Errors from a merged dispatch (bad fd, etc.)
propagate to every member, matching what each unfused call would have
seen; a member whose own buffer is dead fails alone (-EIO), without
dragging the group down.

Wiring: a :class:`Coalescer` hangs off a :class:`SyscallRing` (``fuse=``
knob; per tenant via ``Genesys.tenant(name, fuse=True)`` or globally via
``GenesysConfig.ring_fuse``). :meth:`SyscallRing.dispatch_entries` routes
every popped bundle through :meth:`Coalescer.bundle` — the pre-pass
between ``pop_entries`` and dispatch — so both PollerGroup reaping and
direct ``process_pending()`` callers fuse identically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from repro_torch.core.genesys.syscalls import Sys
from repro_torch.core.genesys.trace import (Counters, EV_COMPLETE, EV_DISPATCH,
                                      EV_FUSE_MERGE)

_U64 = 0xFFFFFFFFFFFFFFFF

# vectorized-scatter heuristics: a fancy-index store pays O(total/8) index
# arithmetic (the store runs on uint64 views, 8 bytes per index op), which
# beats the per-member python loop only when members are many and small —
# few/huge members keep the slice-copy loop, whose memcpy wins past ~0.5 KiB.
# The break-even is measured: qualification is a fixed ~50us of small
# array ops, amortized only past ~64 members; below that the serial loop
# always wins, so the vector path refuses to engage.
_VEC_MIN_MEMBERS = 64
_VEC_MAX_MEMBER = 512


@dataclass
class FuseStats:
    bundles: int = 0            # popped bundles run through the coalescer
    fused_bundles: int = 0      # bundles where at least one group formed
    calls_in: int = 0           # member calls inspected
    fused_calls: int = 0        # members that rode a merged dispatch
    read_groups: int = 0        # merged preads issued
    write_groups: int = 0       # merged pwrites issued
    mmap_groups: int = 0        # batched mmap carves issued
    deduped: int = 0            # members whose exact range repeated another
    dispatches_saved: int = 0   # calls_in-equivalents that never dispatched
    bytes_merged: int = 0       # bytes fetched by merged reads
    bytes_gathered: int = 0     # bytes staged by merged writes
    vector_scatters: int = 0    # scatter-backs that took the fancy-index path


class _ReadMember(NamedTuple):
    """One fusable pread: its bundle index + decoded args. A NamedTuple
    (not __slots__) so ``np.array(members)`` converts a whole group to
    int64 columns in one C pass — the vectorized scatter's qualification
    would otherwise pay a per-member attribute loop that costs as much as
    the copies it saves."""

    idx: int
    buf: int                    # heap handle or fixed-buffer index
    count: int
    offset: int
    dst_off: int
    fixed: int                  # 0/1 (int so the row is homogeneous)


class _WriteMember(NamedTuple):
    """One fusable pwrite: its bundle index + decoded args."""

    idx: int
    buf: int                    # heap handle or fixed-buffer index
    count: int
    offset: int
    src_off: int
    fixed: int                  # 0/1


class Coalescer:
    """Fusion pre-pass for popped ring bundles (see module docstring).

    ``max_span`` bounds a merged dispatch's byte span (one fused pread/
    pwrite never grows past it); ``min_group`` is the smallest member
    count worth a merged dispatch (singletons always pass through).
    """

    FUSABLE_READS = frozenset((int(Sys.PREAD64), int(Sys.PREAD64_FIXED)))
    FUSABLE_WRITES = frozenset((int(Sys.PWRITE64), int(Sys.PWRITE64_FIXED)))
    _FUSABLE_ALL = FUSABLE_READS | FUSABLE_WRITES | {int(Sys.MMAP)}
    # same-fd ops that make hoisting a merged READ unsafe: a close would
    # turn still-valid reads into -EBADF, any write would let earlier-
    # submitted reads observe later bytes. Reads on such fds stay on the
    # serial passthrough path.
    _FD_CONFLICTS = frozenset((int(Sys.CLOSE), int(Sys.WRITE),
                               int(Sys.PWRITE64), int(Sys.PWRITE64_FIXED)))
    # same-fd ops that make hoisting a merged WRITE unsafe: the mirror
    # image — a read submitted before/after a write must keep its serial
    # position relative to it, and a close must still kill later writes
    _WR_CONFLICTS = frozenset((int(Sys.CLOSE), int(Sys.WRITE),
                               int(Sys.READ), int(Sys.PREAD64),
                               int(Sys.PREAD64_FIXED)))
    # non-fusable sysnos that must ride the candidate scan so their fd can
    # veto fusion (fusable sysnos are scanned anyway)
    _VETO_SYSNOS = frozenset((int(Sys.CLOSE), int(Sys.WRITE),
                              int(Sys.READ)))

    def __init__(self, *, max_span: int = 8 << 20, min_group: int = 2):
        self.max_span = int(max_span)
        self.min_group = max(2, int(min_group))
        self.counters = Counters(FuseStats())
        self.stats = self.counters.stats
        # merged-group ids for FUSE_MERGE event attribution (under the
        # counters lock, so no extra lock and no torn ids)
        self._next_gid = 1

    # -- planning ---------------------------------------------------------------
    def _pass_through(self, ring, entries):
        """Nothing fused: account the bundle and hand back a plain batch."""
        from repro_torch.core.genesys.uring import _RingBatch
        self.counters.add(bundles=1, calls_in=len(entries))
        return _RingBatch(ring, entries)

    def bundle(self, ring, entries):
        """Plan one popped bundle: returns a :class:`_FusedBatch` if any
        group formed, else a plain ``_RingBatch`` (zero-cost pass)."""
        n = len(entries)
        # pre-scan on the sysnos the SQEs already carry — no slot touch;
        # conflicting same-fd ops ride along so their fd can veto fusion
        cand = [i for i in range(n) if entries[i][3] in self._FUSABLE_ALL
                or entries[i][3] in self._VETO_SYSNOS]
        n_fusable = sum(1 for i in cand
                        if entries[i][3] in self._FUSABLE_ALL)
        if n_fusable < self.min_group:
            return self._pass_through(ring, entries)
        # gather every candidate's args in ONE fancy-index read + tolist
        # (per-entry structured-scalar access would dominate the plan)
        slot_arr = np.fromiter((entries[i][0] for i in cand),
                               dtype=np.int64, count=len(cand))
        args = ring.area.slots["args"][slot_arr].tolist()
        rd_conflicts = {a[0] for i, a in zip(cand, args)
                        if entries[i][3] in self._FD_CONFLICTS}
        wr_conflicts = {a[0] for i, a in zip(cand, args)
                        if entries[i][3] in self._WR_CONFLICTS}
        pread_fixed = int(Sys.PREAD64_FIXED)
        pwrite_fixed = int(Sys.PWRITE64_FIXED)
        reads: dict[int, list[_ReadMember]] = {}    # fd -> members
        writes: dict[int, list[_WriteMember]] = {}  # fd -> members
        mmaps: dict[int, list[int]] = {}            # size class -> indices
        fusable = 0
        for i, a in zip(cand, args):
            sysno = entries[i][3]
            if sysno == int(Sys.MMAP):
                if a[1] > 0:
                    mmaps.setdefault(_size_class(a[1]), []).append(i)
                    fusable += 1
            elif sysno in self.FUSABLE_READS and a[2] > 0 \
                    and a[0] not in rd_conflicts:   # pread(0) / hazardous
                m = _ReadMember(i, a[1], a[2], a[3], a[4],  # fd: pass thru
                                sysno == pread_fixed)
                reads.setdefault(a[0], []).append(m)
                fusable += 1
            elif sysno in self.FUSABLE_WRITES and a[2] > 0 \
                    and a[0] not in wr_conflicts:
                m = _WriteMember(i, a[1], a[2], a[3], a[4],
                                 sysno == pwrite_fixed)
                writes.setdefault(a[0], []).append(m)
                fusable += 1
        if fusable < self.min_group:
            return self._pass_through(ring, entries)
        read_groups, deduped = self._plan_reads(reads)
        write_groups = self._plan_writes(writes)
        mmap_groups = [(cls, idxs) for cls, idxs in mmaps.items()
                       if len(idxs) >= self.min_group]
        if not read_groups and not write_groups and not mmap_groups:
            return self._pass_through(ring, entries)
        grouped = set()
        for _fd, _lo, _hi, members in read_groups:
            grouped.update(m.idx for m in members)
        for _fd, _lo, _hi, members in write_groups:
            grouped.update(m.idx for m in members)
        for _cls, idxs in mmap_groups:
            grouped.update(idxs)
        passthrough = [i for i in range(n) if i not in grouped]
        n_groups = len(read_groups) + len(write_groups) + len(mmap_groups)
        with self.counters.lock:
            st = self.stats
            st.bundles += 1
            st.fused_bundles += 1
            st.calls_in += n
            st.fused_calls += len(grouped)
            st.read_groups += len(read_groups)
            st.write_groups += len(write_groups)
            st.mmap_groups += len(mmap_groups)
            st.deduped += deduped
            st.dispatches_saved += len(grouped) - n_groups
            st.bytes_merged += sum(hi - lo for _f, lo, hi, _m in read_groups)
            st.bytes_gathered += sum(hi - lo
                                     for _f, lo, hi, _m in write_groups)
            gid0 = self._next_gid
            self._next_gid += n_groups
        tr = ring.trace
        if tr is not None:
            # bundle -> member attribution: each member's user_data tagged
            # with its merged-group id (aux), so the exporter can render
            # the fused span with its member list
            gid = gid0
            for _fd, _lo, _hi, members in read_groups + write_groups:
                tr.rec_block(EV_FUSE_MERGE,
                             [entries[m.idx][3] for m in members],
                             [entries[m.idx][1] for m in members], aux=gid)
                gid += 1
            for _cls, idxs in mmap_groups:
                tr.rec_block(EV_FUSE_MERGE, [entries[i][3] for i in idxs],
                             [entries[i][1] for i in idxs], aux=gid)
                gid += 1
        return _FusedBatch(ring, entries, read_groups, write_groups,
                           mmap_groups, passthrough)

    def _plan_reads(self, reads):
        """Merge each fd's ranges into maximal adjacent/overlapping runs.

        Returns ``([(fd, lo, hi, members), ...], deduped_count)`` where
        every group's ``[lo, hi)`` is exactly the union of its members'
        ranges — never a byte more (gaps split runs) — and has at least
        ``min_group`` members.
        """
        groups = []
        deduped = 0
        for fd, members in reads.items():
            members.sort(key=lambda m: (m.offset, m.count))
            run: list[_ReadMember] = []
            run_end = -1
            seen_ranges: set[tuple[int, int]] = set()
            for m in members:
                if run and m.offset <= run_end \
                        and max(run_end, m.offset + m.count) \
                        - run[0].offset <= self.max_span:
                    run.append(m)
                    run_end = max(run_end, m.offset + m.count)
                else:
                    if len(run) >= self.min_group:
                        groups.append((fd, run[0].offset, run_end, run))
                    run = [m]
                    run_end = m.offset + m.count
                key = (m.offset, m.count)
                if key in seen_ranges:
                    deduped += 1
                seen_ranges.add(key)
            if len(run) >= self.min_group:
                groups.append((fd, run[0].offset, run_end, run))
        return groups, deduped

    def _plan_writes(self, writes):
        """Merge each fd's write ranges into maximal STRICTLY-adjacent
        runs: ``[(fd, lo, hi, members), ...]``.

        Write-ordering rules (conservative by design):

          * overlap anywhere on an fd disqualifies that entire fd — the
            merged result of overlapping writes depends on submission
            order, so all of that fd's writes keep their serial
            passthrough positions (same-fd overlaps never merge);
          * only strict adjacency merges (``m.offset == run_end``): a gap
            would make the merged pwrite touch bytes no member owns;
          * ``max_span`` bounds a run like the read planner.
        """
        groups = []
        for fd, members in writes.items():
            members.sort(key=lambda m: (m.offset, m.idx))
            if any(b.offset < a.offset + a.count
                   for a, b in zip(members, members[1:])):
                continue        # order-dependent overlap: fd stays serial
            run: list[_WriteMember] = []
            run_end = -1
            for m in members:
                if run and m.offset == run_end \
                        and m.offset + m.count - run[0].offset \
                        <= self.max_span:
                    run.append(m)
                    run_end = m.offset + m.count
                else:
                    if len(run) >= self.min_group:
                        groups.append((fd, run[0].offset, run_end, run))
                    run = [m]
                    run_end = m.offset + m.count
            if len(run) >= self.min_group:
                groups.append((fd, run[0].offset, run_end, run))
        return groups


def _size_class(length: int) -> int:
    """MMAP size class: page-rounded length (the pool's own rounding), so
    batched members are exactly the allocations the pool would have made."""
    from repro_torch.core.genesys.memory_pool import PAGE
    return ((int(length) + PAGE - 1) // PAGE) * PAGE


def scatter_read_group(table, scratch, lo, end, members, rets, owner=None,
                       counters=None) -> None:
    """Scatter merged-read bytes from ``scratch`` (covering ``[lo, ...)``,
    valid up to file position ``end``) back into the members' buffers and
    fill each member's exact retval.

    Fast path: when every member's destination is a live, in-bounds,
    non-fixed arena extent, destinations are mutually disjoint, and the
    group shape favors it (>= ``_VEC_MIN_MEMBERS`` members, none larger
    than ``_VEC_MAX_MEMBER``), the whole scatter is ONE fancy-index store
    per backing segment — no per-member python copies. Any other shape
    takes the seed-exact serial loop in submission order (which is what
    gives aliased destinations last-write-wins, and a dead handle its
    lone -EIO).
    """
    heap = table.heap
    if _vector_scatter(table, heap, scratch, lo, end, members, rets, owner,
                       counters):
        return
    # one heap lock round for every non-fixed destination buffer
    dsts = heap.resolve_many(m.buf for m in members if not m.fixed)
    copied = 0
    # scatter in SUBMISSION order (members arrive offset-sorted from
    # the range merge): when two members' destination regions alias,
    # the last submitted write must win, exactly as the unfused
    # serial dispatch would leave the buffer
    for m in sorted(members, key=lambda m: m.idx):
        # exact short-read split: an unfused pread(fd, count, offset)
        # returns min(count, max(0, EOF - offset)) bytes
        avail = min(m.count, max(0, end - m.offset))
        rets[m.idx] = avail
        if avail <= 0:
            continue
        try:
            dst = table._fixed[m.buf] if m.fixed else dsts[m.buf]
            start = m.offset - lo
            np.asarray(dst)[m.dst_off:m.dst_off + avail] = \
                scratch[start:start + avail]
            copied += avail
        except Exception:               # dead handle / bad index: the
            rets[m.idx] = -5            # member alone sees -EIO
    table.note_copy("scatter", copied, owner)


def _vector_scatter(table, heap, scratch, lo, end, members, rets, owner,
                    counters) -> bool:
    """The fancy-index scatter; returns False when the group doesn't
    qualify (caller falls back to the serial loop, which owns ALL the
    edge-case semantics: aliasing, dead handles, out-of-bounds).

    The store runs on ``uint64`` views — 8 bytes per index op — which is
    what makes it beat the per-member memcpy loop (byte-grain fancy
    indexing loses at any realistic member size). That needs every
    destination start, source start, and length 8-byte divisible; arena
    extents start 64B-aligned so pow2-sized members (the coalescing
    regime's shape) qualify, and anything ragged (short read at EOF, odd
    ``dst_off``) falls back to the serial loop."""
    k = len(members)
    if k < _VEC_MIN_MEMBERS:
        return False
    locate_batch = getattr(heap, "locate_batch", None)
    segment = getattr(heap, "segment", None)
    if locate_batch is None or segment is None:
        return False
    scratch = np.asarray(scratch)
    # ONE flat C-level conversion of the whole group (members are
    # NamedTuples), then array ops only — a per-member qualification loop
    # would cost as much as the serial copies it saves
    cols = np.fromiter((f for m in members for f in m), dtype=np.int64,
                       count=k * 6).reshape(k, 6).T
    idxs, bufs, counts, offsets, dst_off, fixed = cols
    if fixed.any():
        return False            # fixed members: serial owns the table path
    # duplicate handles (read dedup / aliased destinations): numpy's
    # duplicate-index assignment order is unspecified, so last-write-wins
    # needs the serial loop. With k unique live handles the extents are
    # mutually disjoint by construction — no overlap check needed beyond
    # the per-extent bounds below.
    bl = bufs.tolist()
    if len(set(bl)) != k:
        return False
    loc = locate_batch(bufs)
    if loc is None:
        return False            # foreign/dead member: serial owns the -EIO
    seg, off, cap = loc
    avail = np.maximum(np.minimum(counts, end - offsets), 0)
    amax = int(avail.max())
    if amax > _VEC_MAX_MEMBER:
        return False            # big member: the slice-copy memcpy wins
    # bounds + sign in ONE reduction: bad iff dst_off < 0 or
    # dst_off + avail > cap for any member
    if int(np.minimum(dst_off, cap - dst_off - avail).min()) < 0:
        return False            # out of bounds: serial owns the ValueError
    rfill = avail               # per-member return values (pre-compression)
    d0 = off + dst_off
    s0 = offsets - lo
    if amax <= 0:               # every member starts past EOF
        total = 0
        avail = avail[:0]
    elif int(avail[-1]) <= 0:   # zero-avail tail (members are offset-
        nz = avail > 0          # sorted, so zeros form a suffix)
        seg, d0, s0, avail = seg[nz], d0[nz], s0[nz], avail[nz]
        total = int(avail.sum())
    else:
        total = int(avail.sum())
    if total:
        # contiguity runs: sequentially carved same-class extents sit back
        # to back in their segment, so the common serving/prefetch shape
        # (N buffers carved at setup, adjacent file ranges) collapses the
        # whole scatter into ~1 slice memcpy; a run needs BOTH sides
        # contiguous
        brk = np.flatnonzero((seg[1:] != seg[:-1])
                             | (d0[1:] != d0[:-1] + avail[:-1])
                             | (s0[1:] != s0[:-1] + avail[:-1]))
        starts = np.concatenate(([0], brk + 1, [avail.size]))
        if (starts.size - 1) * 4 <= avail.size:
            cum = np.concatenate(([0], np.cumsum(avail)))
            for i, j in zip(starts[:-1].tolist(), starts[1:].tolist()):
                ln = int(cum[j] - cum[i])
                d, s = int(d0[i]), int(s0[i])
                segment(int(seg[i]))[d:d + ln] = scratch[s:s + ln]
        elif not ((((d0 | s0 | avail) & 7) != 0).any() or scratch.size % 8
                  or any(segment(s).size % 8 for s in set(seg.tolist()))):
            # ragged but 8-aligned: one uint64-view fancy-index store per
            # backing segment (word grain — byte-grain indexing loses to
            # the memcpy loop at any realistic member size)
            src64 = scratch.view(np.uint64)
            for seg_i in set(seg.tolist()):
                sel = seg == seg_i
                lens = avail[sel] >> 3
                dw = d0[sel] >> 3
                sw = s0[sel] >> 3
                tot = int(lens.sum())
                # ragged index expansion: word j of the concatenation
                # belongs to member i at (j - cum[i-1])
                within = np.arange(tot, dtype=np.int64) \
                    - np.repeat(np.cumsum(lens) - lens, lens)
                segment(seg_i).view(np.uint64)[np.repeat(dw, lens)
                                               + within] = \
                    src64[np.repeat(sw, lens) + within]
        else:
            return False        # ragged and unaligned: serial loop
    il = idxs.tolist()
    rl = rfill.tolist()
    i0 = il[0]
    if il[-1] - i0 == k - 1 and il == list(range(i0, i0 + k)):
        rets[i0:i0 + k] = rl    # adjacent submissions: one slice assign
    else:
        for i, a in zip(il, rl):
            rets[i] = a
    table.note_copy("scatter", total, owner)
    if counters is not None:
        counters.add(vector_scatters=1)
    return True


class _FusedBatch:
    """A popped bundle with a fusion plan; the executor worker runs
    :meth:`process` (same bundle protocol as ``_RingBatch``): claim all
    slots, run passthroughs serially, run each fused group as one
    dispatch + scatter/gather, retire all slots, resolve all futures —
    one lock round per structure, exactly like the unfused batch."""

    __slots__ = ("ring", "entries", "read_groups", "write_groups",
                 "mmap_groups", "passthrough")

    def __init__(self, ring, entries, read_groups, write_groups,
                 mmap_groups, passthrough):
        self.ring = ring
        self.entries = entries
        self.read_groups = read_groups
        self.write_groups = write_groups
        self.mmap_groups = mmap_groups
        self.passthrough = passthrough

    def __len__(self) -> int:
        return len(self.entries)

    def qos_entries(self):
        """The scheduler-chargeable view: one entry per actual kernel
        crossing. Each merged read/write/mmap group charges its FIRST
        member's entry once (the whole group is one dispatch);
        passthrough members charge individually — so WFQ bills fused
        tenants for crossings, not for member counts."""
        charged = [self.entries[i] for i in self.passthrough]
        for _fd, _lo, _hi, members in self.read_groups:
            charged.append(self.entries[members[0].idx])
        for _fd, _lo, _hi, members in self.write_groups:
            charged.append(self.entries[members[0].idx])
        for _cls, idxs in self.mmap_groups:
            charged.append(self.entries[idxs[0]])
        return charged

    def process(self, ex) -> None:
        ring = self.ring
        area, table = ring.area, ex.table
        entries = self.entries
        slots = [e[0] for e in entries]
        n = len(entries)
        rets = [0] * n
        tr = ring.trace
        tr_sys = tr_ud = None
        if tr is not None:
            # shared by DISPATCH and COMPLETE (own=True: never mutated);
            # reuse the pop's column arrays when the bundle carries them
            cols = getattr(entries, "trace_cols", None)
            if cols is not None:
                tr_sys, tr_ud = cols
            else:
                tr_sys = [e[3] for e in entries]
                tr_ud = [e[1] for e in entries]
        try:
            if tr is not None:
                tr.rec_block(EV_DISPATCH, tr_sys, tr_ud,
                             aux=tr.thread_aux(), own=True)
            area.claim_many(slots)
            recs = area.slots
            owner = ring.owner
            for i in self.passthrough:
                rec = recs[slots[i]]
                # the executor's dispatch funnel: fault injection + bounded
                # retry; exceptions net to -EIO inside, like the unfused path
                rets[i] = ex.dispatch_call(rec["sysno"], rec["args"], owner)
            for fd, lo, hi, members in self.read_groups:
                self._run_read_group(ex, fd, lo, hi, members, rets)
            for fd, lo, hi, members in self.write_groups:
                self._run_write_group(ex, fd, lo, hi, members, rets)
            for cls, idxs in self.mmap_groups:
                self._run_mmap_group(table, cls, idxs, rets)
            area.complete_many(slots, rets)
            # counters + COMPLETE events before futures/CQEs become
            # visible (same discipline as _RingBatch.process)
            ex.counters.add(processed=n, ring_processed=n)
            if tr is not None:
                tr.rec_block(EV_COMPLETE, tr_sys, tr_ud, own=True)
            ring._complete_batch(entries, rets)
        finally:
            # mirror _RingBatch.process(): in-flight accounting survives
            # any failure, so drain()/shutdown() can never hang
            with ex._inflight_lock:
                ex._inflight -= n
                if ex._inflight == 0:
                    ex._idle.notify_all()

    # -- fused executors ---------------------------------------------------------
    def _scratch(self, heap, total):
        """A scratch buffer for one merged dispatch: an arena extent when
        the data plane has one (the merged pread/pwrite then runs
        zero-copy through the in-place handlers), else a registered
        ndarray. Returns ``(handle, ndarray view)``; caller releases."""
        carve = getattr(heap, "carve", None)
        if carve is not None:
            sh = carve(total)
            return sh, heap.view(sh)
        scratch = np.empty(total, dtype=np.uint8)
        return heap.register(scratch), scratch

    def _run_read_group(self, ex, fd, lo, hi, members, rets) -> None:
        """One merged pread for the whole ``[lo, hi)`` run, scattered back.

        The merged read goes through the executor's dispatch funnel
        (scratch arena extent), so errno mapping, handler overrides, fault
        injection, bounded retry, and dispatch stats stay uniform — the
        bundle just crosses the "kernel" once, and that one crossing is
        what a fault plan can hit (the whole group shares its fate, like
        a real merged request).
        """
        table = ex.table
        heap = table.heap
        total = hi - lo
        sh, scratch = self._scratch(heap, total)
        try:
            # dispatch_call nets non-OSError failures (e.g. OverflowError
            # on an out-of-C-range offset) to -EIO, same as the unfused
            # per-call dispatch wrapper
            nread = ex.dispatch_call(int(Sys.PREAD64),
                                     [fd, sh, total, lo, 0, 0],
                                     self.ring.owner)
            if nread < 0:                   # merged error: every member
                for m in members:           # sees what its own call would
                    rets[m.idx] = nread
                return
            fuse = getattr(self.ring, "fuse", None)
            scatter_read_group(table, scratch, lo, lo + nread, members,
                               rets, self.ring.owner,
                               fuse.counters if fuse is not None else None)
        finally:
            # release AFTER the scatter: an arena extent returned to the
            # free list could be re-carved by another worker mid-scatter
            heap.release(sh)

    def _run_write_group(self, ex, fd, lo, hi, members, rets) -> None:
        """One merged pwrite for the whole strictly-adjacent ``[lo, hi)``
        run: gather member bytes into scratch, dispatch once, split the
        written-byte count back across members as the exact prefix each
        unfused pwrite would have reported. A gather failure (dead member
        handle) demotes the whole group to serial per-member dispatch so
        the healthy members still land and the dead one alone fails."""
        table = ex.table
        heap = table.heap
        total = hi - lo
        sh, scratch = self._scratch(heap, total)
        try:
            try:
                for m in members:
                    src = heap.view(m.buf) if not m.fixed else None
                    if src is None:
                        src = table._fixed[m.buf] if m.fixed \
                            else heap.resolve(m.buf)
                        src = np.asarray(src)
                    seg = src[m.src_off:m.src_off + m.count]
                    if getattr(seg, "size", len(seg)) != m.count:
                        raise ValueError("short source")
                    scratch[m.offset - lo:m.offset - lo + m.count] = seg
            except Exception:
                self._write_fallback(ex, fd, members, rets)
                return
            table.note_copy("gather", total, self.ring.owner)
            w = ex.dispatch_call(int(Sys.PWRITE64),
                                 [fd, sh, total, lo, 0, 0],
                                 self.ring.owner)
            if w < 0:                       # merged error: every member
                for m in members:           # sees what its own call would
                    rets[m.idx] = w
                return
            for m in members:
                # short-write prefix split: bytes [lo, lo+w) landed, so a
                # member's own pwrite would have written the overlap of
                # its range with that prefix
                rets[m.idx] = min(m.count, max(0, w - (m.offset - lo)))
        finally:
            heap.release(sh)

    def _write_fallback(self, ex, fd, members, rets) -> None:
        """Serial per-member dispatch in submission order (the unfused
        path, args reconstructed) — used when the gather can't stage the
        group, so each member gets its own success/failure."""
        plain, fixed = int(Sys.PWRITE64), int(Sys.PWRITE64_FIXED)
        for m in sorted(members, key=lambda m: m.idx):
            rets[m.idx] = ex.dispatch_call(
                fixed if m.fixed else plain,
                [fd, m.buf, m.count, m.offset, m.src_off, 0],
                self.ring.owner)

    def _run_mmap_group(self, table, cls, idxs, rets) -> None:
        """Same-size-class MMAPs: one pool lock round, one address each."""
        try:
            addrs = table.pool.mmap_many(cls, len(idxs))
        except Exception:
            for i in idxs:
                rets[i] = -5
            return
        for i, addr in zip(idxs, addrs):
            rets[i] = addr

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each fatal on failure:

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (starcoder2-7b: B=8, H=36, KV=4, hd=128, BS=16, table width
   1024, ragged lens up to 4096; paged decode in bf16, f32 and on an int8
   arena, and in bf16 at the main path's own rows: 8 of 16-288 positions
   over phase 3's and phase 15's tables, and of up to 1024 as their step
   alone holds; the paged KV append with an
   out-of-range slot), each K1/K2 case named by the kernel variant it ran
   and every bf16 one bit-equal across two calls, and time kernel,
   plain version, one PyTorch library call as a yardstick, one plain read
   of the same bytes, and the bytes bound at the H100 SXM's 3.35 TB/s
   (data sheet, 700 W limit); and K1 as the step calls it, appending the
   step's token in the same launch (see the fold, below);
3. drive the main path at full width: starcoder2-7b with random weights
   from a seed, bf16, served by ``GenesysUdpServer(use_tenants=True)``
   through the continuous-batching engine over a 2048-block paged arena
   with a spill file; a client thread sends 16 ``[budget, tag,
   prompt...]`` requests (two share a 64-token prefix) by UDP. Every tag
   must come back with exactly its budget of tokens, the shared prefix
   must hit, and K1 must have launched once per layer per step, each
   launch appending the step's token (the append never alone);
4. one paged step's logits with the kernels against the same step with
   the plain attention: full width in bf16, and two layers at full width
   in f32 (greedy tokens equal wherever the top-2 margin exceeds 1e-3).

The dense-cache path (the second slice) adds:

2b. the dense flash-decode kernel (K2) against its plain version in bf16,
    f32 and on an int8 cache, each without and with the step's new token,
    at B=8, H=36, KV=4, hd=128, S=4096 with ragged lens up to 4096, on a
    cache whose S is not a multiple of 512 (nor of 64), and at the shape
    the bucketed serve loop gives it (a bucket of 8 rows, the server's
    largest poll batch, of the 256-position cache) and the eager loop's
    one row of it, and at seamless-m4t-medium's decoder (H=KV=16, hd 64);
    timed against the plain version, one masked
    ``F.scaled_dot_product_attention(..., enable_gqa=True)`` as the
    library yardstick, and the bytes bound;
5.  the dense path at full width, with phase 3's weights: 16 plain
    requests (distinct last tokens) through
    ``GenesysUdpServer(use_tenants=True).serve_model`` eager, the same
    with ``batch_decode=True`` and ``[budget, tag, prompt...]`` requests
    (budgets 8-32), and the same plain requests through
    ``CpuBaselineUdpServer.serve_model`` — the paper's GENESYS-versus-CPU
    comparison. Every reply must carry exactly its budget, eager and CPU
    baseline must return the same token lists (matched by content), and
    K2 must have launched once per layer per decode dispatch in each of
    the three runs, each launch appending the step's token (the KV append
    never launched alone);
5b. one dense step's logits with the kernels against the same step with
    the plain attention, full width bf16, over a filled cache with ragged
    lengths (one row at capacity).

The training path (the third slice) adds:

6.  the flash-attention kernels, forward (K3a) and backward (K3b), against
    their plain versions at the training shapes (B=1, H=36, KV=4, hd=128,
    S=4096, causal) in bf16 and f32, at S=1000 in bf16 (a tail that is no
    multiple of the tiles), at moonshot's H = KV = 16, at Moonlight's
    latent attention (H = KV = 16, a query/key head dim of 192 and a value
    head dim of 128, with the 3% control) and (later slices)
    zamba2's hd 80, and at seamless-m4t-medium's encoder self-attention
    (non-causal, S=4096, H = KV = 16, hd 64) and cross-attention (1024
    queries over 4096 keys): o, lse, dq, dk and dv, timed against the
    plain versions, ``F.scaled_dot_product_attention(...,
    enable_gqa=True)`` forward and forward+backward as the library
    yardstick, and the operations bound at the bf16 peak or the f32
    kernels' split TF32 (the f32 peak's beside it), K3b also
    as its three launches (delta, dq, dk/dv); each output element is held
    to a bound relative to its own size and its head vector's (and the
    kernel's outputs made 3% off in half their rows must fail that rule),
    and two backward calls on the same inputs must give the same bits;
7.  training at full width: starcoder2-7b with 8 of its 32 layers (its
    f32 training state at 32 layers, 118 GB, does not fit the card), f32
    master weights from seed 0, bf16 compute, ``remat="full"``; batches of
    2 x 4096 tokens read by ``GenesysDataLoader`` from a shard of ids in
    [0, 500) synthesised from seed 0, 2 microbatches a step;
    ``Trainer.run(4)`` with a ``CheckpointManager`` saving at step 4, then
    a fresh ``Trainer`` (other weights) that resumes (step 4, every
    restored leaf equal to a host copy bit for bit) and runs 2 more steps.
    Losses and grad norms finite, the last two steps' mean loss below the
    first's, K3a launched 2 x layers x microbatches x steps times (remat
    runs the forward again) and K3b once per layer per microbatch per step;
7b. phase 7's train step at 2 layers of full width: loss and gradients
    with the kernels against the plain attention, in bf16 and in f32
    compute, and a control (one 64-key tile of K and V zeroed) that the
    same comparison must reject.

The hybrid family (the fourth slice) adds, for zamba2-2.7b (54 mamba2
layers and one shared attention + MLP block applied after every 6 of
them; d_model 2560, 80 SSM heads of 64, state 64; random weights from a
seed):

2b. K2 also at the shared block's decode shape: H = KV = 32, hd 80 (G =
    1, K2's CUDA-core variant), a cache of 256 positions, one row in bf16
    and in f32 and a bucket of 8 rows in bf16, each without and with the
    new token; and the KV append into that cache (a bucket of 8 rows in
    bf16, one past capacity, and one row in f32);
6.  one more K3 case at the shared block's shape: H = KV = 32, hd 80;
8.  the SSD scan kernels, forward (K4) and backward (K4b), against their
    plain versions at B=1, L=4096, H=80, P=64, N=64 with x in bf16 and in
    f32, at L=48 (one chunk of 48) and at B=4, L=256, with dt and A drawn
    as Mamba2's initialisation draws them; y, the final state, dx, ddt,
    dA, dBm and dCm each held to an element-wise rule, which the kernels
    run on the two halves of the sequence apart (the middle carry
    dropped) must fail; timed against the plain versions and the
    operations bound (no PyTorch call computes the scan);
9.  training at full width and 18 of the 54 layers (3 of 9 groups of 6
    mamba layers and the shared block, so the shared weights are trained
    through 3 applications; cut to keep the smoke within its time) as
    phase 7 trains: K4 launched twice per mamba layer and microbatch
    (remat runs the forward again), K4b once, K3a and K3b once per
    shared-block application and microbatch;
9b. phase 9's step on one group (6 mamba layers and the shared block),
    kernels against plain in bf16 and f32 (bf16 again on three more
    seeds of weights, decay and tokens), and a control that drops the
    SSD carry into chunk 32;
10. serving at full width in bf16 through phase 5's three dense servers
    (K2 once per shared-block application per dispatch, no scan),
    back-to-back eager requests each returning what it returns alone on
    a template cache that stays unwritten, and
    in f32 a prefill of 256 tokens against the same tokens decoded one at
    a time through the serve step (greedy tokens equal wherever the
    prefill's top-2 margin exceeds 1e-3; a prefill that drops the carry
    into chunk 2 must not pass).

The SSM family (the fifth slice) adds, for rwkv6-3b (32 blocks of time
mix and channel mix, d_model 2560, 40 heads of 64, d_ff 8960, vocab 65536;
3.09 B parameters; random weights from a seed):

11. the WKV kernels, forward (K5) and backward (K5b), against their plain
    versions at B=1, L=4096, H=40, hd=64 with r, k, v in bf16 and in f32,
    at L=48 (one chunk of 48), at B=4, L=256, and with w near the clip
    (log-uniform in [1e-6, 0.2]: both sides finite), w otherwise drawn as
    RWKV-6 initialises its decay (w in [0.69, 0.9975]); o, the final
    state, dr, dk, dv, dw and du each held to phase 8's element-wise rule,
    which the kernels run on the two halves of the sequence apart must
    fail (all but du, which the carry does not reach); timed against the
    plain versions and the operations bound (no PyTorch call computes the
    WKV);
12. training at full width and 8 of the 32 blocks (cut to keep the smoke
    within its time) as phase 7 trains: K5 launched twice per block and
    microbatch (remat), K5b once, every other kernel never;
12b. phase 12's step on 2 blocks, kernels against plain in bf16 and f32
    (bf16 again on three more seeds of weights and tokens), with RWKV-6's
    decay and bonus init, and a control that drops the WKV carry into
    chunk 32;
13. serving at full width in bf16 through phase 5's three dense servers
    (no kernel: the decode recurrence is plain torch, as in the
    reference), back-to-back eager requests, and in f32 (with RWKV-6's
    decay init) a prefill of 256 tokens through K5 against the same tokens
    decoded one at a time, with a control that drops the carry into chunk
    2.

The MoE family (the sixth slice) adds, for moonshot-v1-16b-a3b (48
layers, d_model 2048, 16 heads over 16 KV heads of 128, 64 experts of d_ff
1408, top-6, vocab 163840; 28.06 B parameters, 3.98 B active a token;
random weights from a seed):

2, 2b. K1 at its decode shape (H = KV = 16, hd 128, G = 1: 8 ragged rows
    up to 4096) and K2 at its dense serving shapes (one row and a bucket
    of 8 over the 256-position cache), bf16, against their plain versions;
14. the grouped-matmul kernels, forward (K6) and gradient (K6b: dx and
    dw), against their plain versions at the expert products' shapes (64
    groups of d_model 2048 -> d_ff 1408) with 512 rows a group (training)
    and 4 (a decode step's capacity), in bf16 and f32, the
    down-projection (1408 -> 2048) at 512 rows in bf16 and f32, and 9
    tiles of 200 rows over 8 experts with one tile's id out of range and
    one expert without tiles in bf16 and f32 (both must read zero), each
    output element held to phase 6's rule (f32 also to a relative
    Frobenius error of 1e-5), which a control (tile 1's expert id
    shifted) must fail, and K6b bit-equal across two calls; timed (K6b
    whole and as its dx and dw launches) against the plain versions,
    ``torch.bmm`` over the same tiles and the bound (in f32 the design's,
    split TF32 for its tiles over 16 rows and dw, and the f32 peak's
    beside it); and ``ops.moe_gmm_apply`` (sort, pad and tile ids on the
    device) through K6 and K6b against the plain versions
    at the reference's ragged test shapes (random experts with one left
    empty; every token on one expert);
15. the main path at full width and all 48 layers in bf16: phase 3's
    requests through the paged engine over a 1024-block arena (6.4 GB
    beside 56.1 GB of weights), K1 (appending the token) once and K6 three
    times per layer and step; the assignments the capacity dropped, counted on
    the device and read once; one decode step alone, host clock against
    device busy time and the bytes bound of the weights it reads;
16. the three dense servers (phase 5's requests; eager and CPU baseline
    equal, a one-row step dropping nothing), and one step of a bucket of
    8 rows against each row alone, the logits of every row that lost no
    assignment held to its step alone;
17. training, 2 of 48 layers (the one cut: 449 GB of f32 state at 48;
    4 layers before phases 5c and 21 had to fit) as phase 7 trains, K6
    six times (remat) and K6b three times per layer and microbatch; model
    FLOPs on the active parameters;
17b. two layers' train step with K6/K6b against their plain versions in
    bf16 and f32, and a control (tile 1's expert id shifted) that must
    fail.
23. (run after 17b) Moonlight-16B-A3B, the benchmark's MoE cell, at its
    published widths: K6 and K6b over a real dropless table (one row of
    4096 tokens routed by sigmoid scores plus the selection bias and
    sorted by ``ops.moe_dispatch`` into 256 tiles of 128 rows, the spare
    tiles past the last group with id E) for the gate/up and the down
    products in bf16, by phase 14's rule, control and zero checks; then
    one train step at the cell's depth (5 layers, 2 x 4096 tokens)
    through ``make_train_step`` with every counter set to 0 just before
    it: K3, K6/K6b, the dispatch and AdamW's kernels launched as the
    layers say, the frozen selection bias left to no kernel; the kernels
    line gives those launches by run.
18. device-initiated syscalls: ``Genesys.invoke`` on CUDA tensors (the
    kernel of ``csrc/genesys_invoke.cu`` posting GENESYS's slots into
    mapped host memory) against the plain host entry (the same calls on
    CPU tensors), at the reference's sizes: the quickstart's pread with
    ``tie``; Fig. 5's preads of 1, 4 and 16 MB at work-item (4 KB pages),
    work-group (64 pages) and kernel granularity, every retval and byte
    equal to the plain entry's and the file's, interrupts one a row or a
    call; Fig. 6's four ordering x blocking modes over 16 pwritten blocks
    of 8 KB after 1, 8 and 32 permutations on the card; Fig. 7's 64-row
    batches of 4, 64 and 512 KB without and with coalescing (bundles of 1,
    and of 2-8); the ring (``via_ring``); both rule errors with nothing
    launched; a control (offsets one page on) that must fail; round trips
    of one blocking CLOCK_GETTIME at each granularity and of 64 rows, and
    of one blocking row answered by a bare host responder (the same slot
    protocol with no executor: the device entry's floor, its bound); and,
    with the host's poller stopped, a call that gives up after its bound.

The encoder-decoder (the eighth slice) adds, for seamless-m4t-medium (12
encoder and 12 decoder layers, d_model 1024, 16 heads of 64, d_ff 4096,
vocab 256206; 0.877 B parameters; random weights from a seed; 4096 frames
a row, AR(1) stand-in audio features from a seeded generator):

19a. the decode step's cross-attention alone (4 rows, one query each over
    4096 encoder positions) through K2, its route, and through K3a at Sq =
    1, against the plain version, SDPA and the bytes bound; then serving
    at the step level, as the reference's test serves this family: 4
    requests of 4096 frames, ``encode`` once, prompts of 16-64 tokens fed
    one a step through ``make_serve_step(cfg)(params, cache, tok,
    cache_len, enc_out)`` over a carried cache of 256 positions, then 32
    greedy tokens each, the rows' cache lengths ragged. K2 launched 24
    times a step (12 self-attention, each appending the token, 12
    cross-attention), the append alone never, K3a 12 for the encode and
    36 for a no-cache forward, nothing else; the
    served tokens equal a teacher-forced replay's argmax; decode against
    the no-cache forward in bf16 (0.25) and, at 2 + 2 layers in f32, greedy
    tokens where the margin exceeds 1e-3; one decode step and one no-cache
    forward with the kernels against the plain attention, and a control
    (the cross-attention cut to 2048 positions) that must fail;
19b. training at full width and all 24 layers as phase 7 trains (2 rows
    of 4096 frames and 1024 text tokens a step, the frames added to the
    loader's batches), K3a twice and K3b once per attention (12 + 24) per
    microbatch; the train step at 2 + 2 layers against the plain attention
    with phase 7b's control, at the frames' scale and at a scale where the
    encoder's output hardly varies over its positions (K3b's delta from
    the unrounded o).

The multi-device and planning tools (the ninth slice) add, with no new
kernel:

20a. remat="dots" at full width: starcoder2-7b at 4 of its 32 layers,
    phase 7's batch (2 x 4096 tokens in 2 microbatches, bf16 compute with
    the kernels, f32 master weights from one seed), two steps each under
    "none", "full" and "dots" (the second timed): dots' first loss and
    every gradient held to
    "none"'s and "full"'s by phase 7b's rule (and whether they are
    bit-equal), peak memory above each step's start ordered none > dots >
    full, K3a launched twice a layer and microbatch under full and dots
    (once under none) and K3b once, the products dots keeps (the weight
    products: q, k, v, o and the MLP's) a layer times layers times
    microbatches; the control, dots with a policy that keeps nothing,
    must give full's peak and keep nothing, failing that count;
20b. the dry run (``repro_torch.launch.dryrun.run_cell``) of
    seamless-m4t-medium decode_32k on the 2 x 16 x 16 mesh and
    starcoder2-7b decode_32k on the 16 x 16 one, over fake worlds of 512
    and 256 ranks in a subprocess that sees no card: status, H100
    roofline terms, peak GiB a device, collectives by op;
20c. a real mesh over the card (NCCL, world 1, ``make_host_mesh``):
    ``rules_for`` every arch gives kv_rep 1 and every parameter
    replicated; 8 greedy starcoder2-7b decode steps (32 layers, bf16)
    give the same tokens with the rules as without; int8_ef of 20a's
    gradient tree on the card equals the CPU's bit for bit (timed); a
    compressed all-reduce (bf16, int8_ef) over the group returns the
    dequantised tree.

The fold of the KV append into K1 and K2 (a later kernel redesign) adds
to phases 2 and 2b a case of each K1/K2 case as a decode step calls the
kernel: the step's token written at its slot and attended in one launch
(K1 attending it as the arena stores it, K2 unquantised), the output held
to the case's tolerance against the plain two calls (append then attend;
attend then append), the written cache bit-equal to the plain append's
(int8 included), a second call giving the same bits, one slot out of
range, and a control (every slot one on) that must fail; timed against
the append and attention kernels called one after the other. Every
serving path (phases 3, 5, 10, 13, 15, 16, 19a) must launch the append
alone 0 times and K1/K2 as often as before, each launch appending, and
the steps alone print their device operations.

The last modules of the port add:

2.  K1 also at Fig. 12's block size of 4 positions (bf16, 8 rows of 2-33
    positions over a table of 48 blocks), alone and appending the token;
5c. Fig. 12's serving workload (``benchmarks/fig12_serving.py``) at full
    width on phase 3's weights, with the reference's constants. Part A:
    48 one-token requests (the reference's --quick) from seed 1207 with
    bimodal budgets (2-6 tokens, a quarter 28-32), a burst of 16 and then
    arrivals paced at 2.2x the service rate the continuous engine's
    calibration drain measures, replayed against the closed buckets
    (``serve_model(batch_decode=True, per_request_tokens=True)`` over a
    40-position cache, K2) and the continuous engine
    (``serve_model_continuous``, 8 slots over 96 blocks of 4, K1): every
    tag answered with exactly its budget by both, K1 and K2 once per
    layer and step or dispatch, each launch appending; tokens/s of each,
    their ratio (the reference gates it at 1.5x: printed, not gated here),
    p50/p99 latency, steps per dispatch, occupancy and the arena's RSS
    peak printed. Part B: 12 sharers of a two-block prefix over 12 blocks
    of 4, then a 40-token request that evicts it through a PWRITE64 spill
    and a sharer that revives it with PREAD64_FIXED: prefix hits, a spill,
    a revival, and the revived sharer's tokens equal to the same request's
    on a fresh engine that evicted nothing;
6.  K3a/K3b also at the reduced configs' heads (H 4 over KV 2, hd 32) at
    S 4096 and 1000, causal, in bf16 (the wgmma kernels) and f32 (the
    split-TF32 ones), each with the 3% control;
21. the examples in this process through their ``main`` on the card:
    ``torch_memory_hints`` (RSS after each phase and release),
    ``torch_serve_echo`` (reduced rwkv6-3b over UDP, 6 tokens) and
    ``torch_train_lm --steps 20`` (reduced internlm2-20b: async
    checkpoints, kill and resume, 10 more steps; K3a and K3b launched
    once per layer and step; the loss must fall); then, in subprocesses,
    ``torchrun --standalone --nproc_per_node 1 -m repro_torch.launch.train
    --arch A --reduced --steps 12 --lr 3e-3`` for internlm2-20b,
    zamba2-2.7b, rwkv6-3b and moonshot-v1-16b-a3b (data-parallel worlds of
    one over NCCL, the attention's, the scans' and the experts' kernels on
    the rank's rows; each loss must fall, and each kernel of the model's
    path must launch: K3 at hd 32, K4, K5, K6/K6b) and
    ``python -m
    repro_torch.launch.serve --arch starcoder2-7b --reduced``, dense
    (``--batches 1``) and ``--continuous``, each answering a UDP request;
    every one must exit 0 and print what its docstring promises.

The fused optimizer step (``kernels/csrc/adamw.cu``) adds, run right after
phase 2b while the card holds little else:

22. AdamW's kernels (the norm, then the update) against the eager route
    (``AdamW.update_plain``) at the benchmark cells' leaf shapes:
    starcoder2-7b at 8 layers (11 leaves, 2.19 B parameters, 2
    microbatches) and zamba2-2.7b at 54 (20 leaves, 2.42 B, 1), one step
    from seeded moments at count 10 with the clip engaged; the norm to
    ADAMW_NORM_RTOL of the eager one and every element by the card test's
    rule (``tests/test_torch_adamw.py``), two norms of the same gradients
    the same bits. Timed: the kernels (norm and update apart and together)
    against the bytes bound (4, 28 and 32 bytes a parameter at 3.35 TB/s),
    the eager route, and ``clip_grad_norm_(foreach=True)`` with
    ``torch._fused_adamw_`` as the library yardstick (its update alone
    beside). Each training phase (7, 9, 12, 17, 19b) sets AdamW's launch
    and leaf counters to 0 before its run and checks them after it: one
    norm and one update launch a step, every leaf through the kernels, none
    through the eager route; the kernels line gives them by run.

The redesign of K3a/K3b at hd 32 (bf16 on wgmma and TMA, one consumer
warpgroup and two CTAs an SM) adds to phase 6 the training example's shape
(B 8 x S 64, bf16, with the 3% control) and an SFU term in every K3 case's
bound (the exponentials: one a (query, key) pair, forward and backward, at
``SFU_OPS_PER_S``); the kernels line records hd 32's times, bounds, SDPA
times and launches beside the path's hd-128 case. Every case's two bf16
backward calls, hd 32 with G = 2 included, must give the same bits.

The redesign of K3a/K3b in f32 (split TF32 on ``mma.sync``) adds to phase
6 f32 cases at zamba2's hd 80 and seamless's encoder (hd 64), and the 3%
control at starcoder2's hd-128 f32 case; an f32 case's bound is the split
design's (three tf32 products a product at the TF32 rate), the f32 peak's
beside it (``bound_f32_ms``). Phases 7b, 9b, 17b and 19b count the f32
step's K3 launches, which the kernels line gives apart from the path's
bf16 ones.

Prints a ``{"kernels": [...]}`` JSON line and, last, ``{"ok": true,
"device": {...}}``. Exits non-zero without a result when no CUDA device
is visible or the port's sources are not beside this script.
"""
from __future__ import annotations

import ast
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate (data sheet, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per dtype
TF32_FLOPS = 495e12                # dense TF32 tensor-core rate (data sheet)
# exponentials (ex2.approx) a second on the card's special-function units:
# experiments/torch_mma_rate.py read 3.94e12-4.16e12 on an H100 80GB HBM3
# at 700 W (lg2.approx the same; the CUDA guide gives 16 a clock per SM
# for compute capability 9.0); the highest is the bound's rate. It is the
# MUFU pipe's rate alone: an exp2 can also be computed by a polynomial on
# the FMA pipes, so a term at this rate is no hard floor
SFU_OPS_PER_S = 4.16e12
F32_ATOL = 1e-4                    # kernel vs plain, f32 outputs
# one bf16 step, kernels vs plain: the attention outputs differ by about
# one bf16 ulp, and 32 layers of random weights carry that into logits of
# |logit| up to ~5, where a bf16 ulp is 1/32: held to 8 such ulps
LOGITS_ATOL_BF16 = 0.25
MARGIN_F32 = 1e-3
# Host-plane pollers park after one empty round and sleep up to 50 ms
# (a submission's edge wakes them at once, so syscall latency does not
# suffer): a poller that spins or wakes often takes the GIL between the
# hundreds of small PyTorch calls of an eager decode step and holds each
# up (the defaults, 64 spin rounds and 2 ms parks, made the serving step
# several times slower on an H100 80GB HBM3 at 700 W; see PERF.md).
POLLER_SPIN = 1
POLLER_MAX_SLEEP_S = 0.05

B, H, KV, HD, BS = 8, 36, 4, 128, 16
N_BLOCKS, TABLE_WIDTH = 2048, 1024   # make_engine's default table: NB // 2
MAX_LEN = 4096
# the dense path: the launcher's cache of one row and 256 positions,
# tiled to a power-of-two bucket by the bucketed loop
DENSE_LEN, N_DENSE_REQS, EAGER_TOKENS = 256, 16, 16
# the training path: starcoder2-7b at full width, depth cut to 8 layers
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 8, 4096, 2, 2
TRAIN_STEPS, RESUME_STEPS = 4, 2
# phase 22, AdamW's kernels against the eager route (the card test's rule,
# tests/test_torch_adamw.py): the norm sums ~2.4e9 squares in another
# order; the rest rounds as the eager route does, so v to 2e-5 of itself
# (the scale squared), m to 2e-5 of its leaf's largest (its terms may
# cancel), p to 2^-21 of itself plus 4e-5 of its step lr |m_hat| /
# (sqrt(v_hat) + eps), or of lr where the step is smaller (the card test's
# steps are; the phase's seeded moments, drawn apart, give steps of ~400 lr)
ADAMW_NORM_RTOL = 1e-5
ADAMW_CELLS = (("starcoder2-7b", TRAIN_LAYERS, 2), ("zamba2-2.7b", None, 1))
# K3 vs plain, each element of o, dq, dk and dv:
#   |got - ref| <= r * (|ref| + rms_vec + rms / 16)
# rms_vec is the RMS of the element's own head vector (one query row or
# key of one head) and rms that of the whole tensor. The size of an output
# vector falls with the number of keys or queries it sums (|o| ~ sqrt(e/i)
# for row i), by 20x and more over S = 4096, so each vector is held to its
# own size; rms / 16 covers vectors that cancel to ~0 (row 0's dq). bf16:
# the kernels round p and dS to bf16 (2**-9 relative, random over the
# terms of each sum) and both sides round each output once (at most one
# ulp, <= 2**-7 of it): r = 2**-6, two ulps at most. f32: the same sums in
# another order, r = 2**-13. Besides, the whole tensor's relative
# Frobenius error ||got - ref|| / ||ref|| is held to FA_FROB. lse is an f32
# log-sum-exp of f32 scores either way: 1e-4.
FA_REL = {"bfloat16": 2.0 ** -6, "float32": 2.0 ** -13}
FA_FROB = {"bfloat16": 1e-2, "float32": 1e-5}
FA_LSE_ATOL = 1e-4
# the control: the kernel's outputs with the second half of their rows
# (or keys) 3% off must fail the element-wise rule, in these cases
FA_CONTROL_SCALE = 1.03
FA_CONTROL_CASES = ("S4096-bfloat16", "S4096-float32", "S4096-hd32-bfloat16",
                    "S4096-hd32-float32", "S1000-hd32-bfloat16",
                    "S1000-hd32-float32", "B8-S64-hd32-bfloat16",
                    "S4096-mla-192-128-bfloat16")
# the reduced configs' attention as the training example runs it on the
# card: a batch of 8 rows of 64 positions
FA_PATH_BATCH, FA_PATH_SEQ = 8, 64
# one train step (phase 7's step at 2 layers), kernels vs plain attention:
# loss to 1e-3 (bf16) or 1e-5 (f32), and each gradient leaf, read from
# the step's first moments, by its relative norm ||g - g_ref|| / ||g_ref||
# to 2e-2 (bf16) or 1e-4 (f32). The control, plain attention with one
# 64-key tile of K and V zeroed, must fail them.
STEP_LOSS_ATOL = {"bfloat16": 1e-3, "float32": 1e-5}
STEP_GRAD_REL = {"bfloat16": 2e-2, "float32": 1e-4}
CONTROL_KEYS = (2048, 2112)
# K4/K4b vs plain, each output element by phase 6's rule (fa_reading):
#   |got - ref| <= r * (|ref| + rms_vec + rms / 16)
# with rms_vec over the last axis (P, N or the heads). The plain version
# computes in f32; the kernels' products run on the tensor cores in split
# TF32 (a_hi b_hi + a_hi b_lo + a_lo b_hi, each part rounded to tf32 and
# accumulated in f32: a few 2**-24 of each product's size, where an f32
# product rounds once; a bf16 operand is exact and its lo part zero), the
# chunk's scores C B^T in a three-part split summed in f64, and the running
# sum of dt A in the plain version's order: the two differ by the order of
# their sums and those products' last bits. r = 2**-13 for an f32 output,
# as for phase 6's f32 kernels; this phase is what holds the kernels to it
# (tests/test_torch_mamba2.py emulates the operands' rounding on the CPU,
# not the tensor core's sums, and shows one tf32 product per product
# failing it: why the products split). A bf16 output (y and dx
# when x is bf16) is rounded once from those f32 values on each side, so
# the two may land one bf16 ulp apart (<= 2**-7 of it): r = 2**-6, as in
# phase 6.
SSD_REL = {"bfloat16": 2.0 ** -6, "float32": 2.0 ** -13}
# K6/K6b in f32 (phase 14) also to a relative Frobenius error of the whole
# output: its decode tiles multiply in f32, its larger tiles and dw in split
# TF32 (tests/test_torch_gmm_tf32.py: one tf32 product fails both rules)
GMM_F32_FROB = 1e-5
# the control, the kernels run on the two halves of the sequence apart
# (the carry across the middle boundary dropped), must fail that rule in
# these outputs
SSD_CONTROL_FAILS = ("y", "dx", "dBm", "dCm")
# K5/K5b vs plain, each output element by the same rule and for the same
# reason: the kernels' products run on the tensor cores in split TF32 as
# K4's do (a bf16 r, k, v or do exact, its lo part zero), the decays of a
# pair of 16-row blocks factored around a reference point and the
# diagonal blocks' decays formed per element, cs summed in the plain
# version's order: the two differ by the order of their sums and those
# products' last bits (tests/test_torch_rwkv6.py emulates the operands'
# rounding and shows one tf32 product per product failing the rule). o,
# dr, dk, dv in r's dtype (a bf16 output rounded once on each side), the
# final state, dw and du in f32
WKV_REL = SSD_REL
# the halves control must fail the rule in every output the carry reaches:
# du (sum_t (do_t . v_t) r_t k_t) does not depend on the state
WKV_CONTROL_FAILS = ("o", "dr", "dk", "dv", "dw")
# Near the clip (w down to 1e-6) dw = d log w / w, where d log w is a
# reverse running sum over the chunk of terms of size |r k dA| whose signs
# cancel to a result of size about w: both versions carry a rounding error
# of about 2**-24 times those terms' sum, which 1/w then amplifies past any
# bound relative to the element (a first check on an H100 read errors of
# 1.4e5 times it). There dw is held through w * dw, the gradient with
# respect to log w that the running sum computes, each element to 2**-13
# of the largest |w * dw| of the tensor; the other outputs keep the rule.
WKV_CLIP_REL = 2.0 ** -13
# phase 10: decode against a prefill of 256 tokens (4 chunks)
PREFILL_LEN = 256
# the MoE family (moonshot-v1-16b-a3b): serving over an arena of 1024
# blocks of 16 tokens (6.4 GB at 393 KB a token) beside 56.1 GB of bf16
# weights; training cut to 2 of 48 layers (the f32 state is 47.3 GB at 4
# layers and 449 GB at 48; 4 layers until the examples' and Fig. 12's
# phases had to fit in the smoke's time: their checkpoint's save and
# restore took ~118 s of phase 17's ~200)
MOE_N_BLOCKS = 1024
MOE_TRAIN_LAYERS = 2
# phase 23: Moonlight-16B-A3B at its benchmark cell's depth (the dense
# layer and 4 MoE layers; ~59 GB at the step's peak)
MOONLIGHT_TRAIN_LAYERS = 5
# the recurrent families' training depth (phases 9 and 12), cut from 54
# and 32 so the smoke keeps within its time with the MoE phases: at full
# depth their checkpoints (29 and 37 GB) took 56-95 s each to save and
# restore; 3 of zamba2's 9 groups (6 mamba layers and the shared block,
# which is then trained through 3 applications), 8 of rwkv6's 32 blocks
HYBRID_TRAIN_LAYERS = 18
SSM_TRAIN_LAYERS = 8
# phase 12b's bf16 step again on these seeds of weights and tokens (phase
# 9b's are 21-23)
WKV_STEP_SEEDS = (31, 32, 33)
# phase 19, the encoder-decoder (seamless-m4t-medium, all 12 + 12 layers):
# 4 requests of 4096 frames each, prompts of 16-64 tokens and budgets of
# 32, fed one token a step over a carried cache of 256 positions; training
# rows of 4096 frames beside 1024 text tokens. The frames are AR(1) stand-in
# audio features that decorrelate over FRAME_CORR frames, FRAME_STD an
# element: at 1 (the token embeddings' scale) a random-weight encoder's
# non-causal attention adds nearly one vector to every position, its output
# hardly varies over positions, and no logit check can see which positions
# the decoder's cross-attention reads (cutting it to 2048 of 4096 moved the
# logits by 0.088, under the 0.25 rule; 1.625 at FRAME_STD 32, on an H100);
# the train step is also held to its plain version at FRAME_STD 1, where
# K3b's dq and dk need delta from the unrounded o. The control cuts the
# decode step's cross-attention to its first ENCDEC_CUT_LENS positions
ENCDEC_ROWS, ENCDEC_PROMPTS, ENCDEC_BUDGET = 4, (16, 64), 32
ENCDEC_CACHE, ENCDEC_TEXT, ENCDEC_CUT_LENS = 256, 1024, 2048
FRAME_CORR, FRAME_STD = 256, 32.0
# phase 20: remat "dots" at 4 of starcoder2-7b's 32 layers; the control's
# peak (a policy that keeps nothing) within 2% of "full"'s; the dry run's
# subprocess gets this long; greedy decode steps with and without the rules
DOTS_LAYERS = 4
DOTS_CONTROL_PEAK_REL = 0.02
DRYRUN_TIMEOUT_S = 300
HOST_MESH_STEPS = 8
# phase 16: a bucket row that lost no assignment against its step alone:
# 8 bf16 ulps of the largest |logit|, as phase 4a holds starcoder2's
# logits (0.25 at |logit| ~5)
MOE_BUCKET_ULPS = 8
# phase 5c: benchmarks/fig12_serving.py's workload at full width, on phase
# 3's weights, with the reference's constants: 8 slots, budgets of at most 32
# tokens, blocks of 4 positions, arrivals paced at 2.2x the continuous
# engine's service rate after a burst of two slots' worth; Part A's 48
# requests (the reference's --quick run; its full run of 128 took 75 s
# of Part A on an H100 80GB HBM3 machine whose host ran the engine's step
# in 104 ms, and the smoke 1085 s, over its budget) from seed 1207 over a
# 96-block arena; Part B's 12 sharers of a two-block prefix
# over 12 blocks of 4, two slots and a table of 10 blocks, then a
# 40-token request that evicts the prefix and a sharer that revives it.
FIG12_SLOTS, FIG12_MAX_TOKENS, FIG12_BLOCK = 8, 32, 4
FIG12_OVERSUBSCRIBE = 2.2
FIG12_REQUESTS, FIG12_SEED, FIG12_ARENA = 48, 1207, 96
FIG12_SHARERS = 12


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def zero_counts(counters) -> None:
    """Set the launch counts of kernel wrappers to 0 (K1's and K2's
    launches that also appended the step's token too)."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "fused_launches"):
            c.fused_launches = 0


def read_counts(counters) -> dict:
    """{wrapper name: launches}, and for K1 and K2 also
    ``<name>_fused``: the launches that appended the step's token."""
    out = {c.__name__: c.launches for c in counters}
    out.update({f"{c.__name__}_fused": c.fused_launches for c in counters
                if hasattr(c, "fused_launches")})
    return out


# ------------------------------------------------------------- timing ----

# GPU clock cycles to hold the stream busy while the host enqueues a call:
# about 4 ms at an H100 SXM's 1.98 GHz boost clock, longer than any call
SLEEP_CYCLES = 8_000_000


def cuda_ms(torch, fn, *, reps: int, flush) -> tuple[float, float]:
    """Device and host time of one call of ``fn``, medians over ``reps``.

    Device: CUDA events around each call, with L2 flushed before it (the
    serve step meets every layer's KV cold) and the stream held busy by a
    GPU sleep while the host runs the wrapper, so the events bracket the
    device work alone and not the host's launch overhead. Host: wall time
    of the call itself (it does not wait for the device)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    host = []
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in ev),
            statistics.median(host))


def tolerance(name: str, want) -> float:
    """Kernel vs plain: f32 outputs agree to F32_ATOL (sums in another
    order). A bf16 output is rounded once from f32 sums that differ in
    order and in the plain version's bf16-rounded softmax weights, so the
    two may land one bf16 ulp apart, and the ulp grows with |output| (the
    int8 case dequantises to |v| up to 8): two ulps of the largest
    |output|, 2 ** (floor(log2(max |o|)) - 6)."""
    if name == "float32":
        return F32_ATOL
    amax = want.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(max(amax, 2.0 ** -100))) - 6)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------ phase 2: kernels --

def decode_inputs(torch, dev, gen, q_dtype, kv_dtype, heads=(H, KV, HD), *,
                  lens_range=(1, MAX_LEN), table_width=TABLE_WIDTH,
                  block_size=BS):
    """Ragged rows: row b holds lens[b] positions on distinct random
    blocks of ``block_size`` positions; the rest of its table points at
    the null block. ``heads`` = (query heads, KV heads, hd); lens are
    drawn from ``lens_range`` with row 0 at its top."""
    h, kv, hd = heads
    lens = torch.randint(lens_range[0], lens_range[1] + 1, (B,),
                         generator=gen, device=dev, dtype=torch.int32)
    lens[0] = lens_range[1]
    pages = [(int(n) + block_size - 1) // block_size for n in lens.tolist()]
    n_blocks = max(N_BLOCKS, 1 + sum(pages))
    order = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = torch.zeros((B, table_width), dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(pages):
        bt[b, :n] = order[at:at + n].to(torch.int32)
        at += n
    q = torch.randn(B, h, hd, generator=gen, device=dev).to(q_dtype)
    shape = (n_blocks, block_size, kv, hd)
    if kv_dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
    return q, kp, vp, bt, lens, pages


def read_ms(torch, nbytes: int, flush) -> float:
    """Device time of one plain contiguous read of ``nbytes`` (a bf16 sum)
    under the same flush as the kernels: what the memory gives a call that
    reads as many bytes, beside the bound (the flush leaves L2 full of
    dirty lines, so a read also pays their write-back)."""
    buf = torch.ones(max(nbytes // 2, 1), dtype=torch.bfloat16,
                     device=flush.device)
    ms, _ = cuda_ms(torch, lambda: buf.sum(dtype=torch.float32), reps=10,
                    flush=flush)
    return ms


def same_bits(torch, fn) -> bool:
    """Two calls of ``fn`` give the same bits (the kernels' merges run in a
    fixed order)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return torch.equal(a, b)


def library_attention(torch, q, kp, vp, bt, lens, n_pages):
    """Yardstick only, never on the path: gather the valid pages, then one
    F.scaled_dot_product_attention call (the gather is included)."""
    F = torch.nn.functional
    bs, kv, hd = kp.shape[1:]
    kd = kp[bt[:, :n_pages].long()].reshape(B, n_pages * bs, kv, hd)
    vd = vp[bt[:, :n_pages].long()].reshape(B, n_pages * bs, kv, hd)
    if kp.dtype == torch.int8:
        kd, vd = kd.to(q.dtype) / 16.0, vd.to(q.dtype) / 16.0
    mask = (torch.arange(n_pages * bs, device=q.device)[None]
            < lens[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)[:, :, 0]


def kernel_phase(torch, dev, flush, moe, fold: bool = True):
    """K1 at starcoder2's shape in bf16, f32 and int8, and at the MoE
    model's (``moe`` = (H, KV, hd)) in bf16, over rows of up to MAX_LEN
    positions; then both at the main path's own rows (8 of 16-288
    positions: phase 3's prompts of 16-256 tokens and budgets of 8-32, over
    the tables make_engine gives phases 3 and 15) and at the rows of up to
    1024 positions of phases 4 and 15's step alone, and at phase 5c's
    block size of 4 positions (rows of 2-33 over a table of 48 blocks: Fig.
    12's one-token prompts and budgets of up to 32); with ``fold``, each
    case again as the decode step calls K1, appending the step's token in
    the same launch (:func:`paged_fold_case`); the KV append alone.
    Returns (K1's cases, the fused cases, the append's case)."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases, folded = [], []
    serving = {"lens_range": (16, 288)}
    step = {"lens_range": (16, 1024)}
    for name, q_dtype, kv_dtype, heads, rows in (
            ("bfloat16", torch.bfloat16, torch.bfloat16, (H, KV, HD), {}),
            ("float32", torch.float32, torch.float32, (H, KV, HD), {}),
            ("int8", torch.bfloat16, torch.int8, (H, KV, HD), {}),
            ("moe-bfloat16", torch.bfloat16, torch.bfloat16, moe, {}),
            ("serve-bfloat16", torch.bfloat16, torch.bfloat16, (H, KV, HD),
             dict(serving, table_width=N_BLOCKS // 2)),
            ("moe-serve-bfloat16", torch.bfloat16, torch.bfloat16, moe,
             dict(serving, table_width=MOE_N_BLOCKS // 2)),
            ("step-bfloat16", torch.bfloat16, torch.bfloat16, (H, KV, HD),
             dict(step, table_width=N_BLOCKS // 2)),
            ("moe-step-bfloat16", torch.bfloat16, torch.bfloat16, moe,
             dict(step, table_width=MOE_N_BLOCKS // 2)),
            ("fig12-bs4-bfloat16", torch.bfloat16, torch.bfloat16,
             (H, KV, HD), dict(lens_range=(2, FIG12_MAX_TOKENS + 1),
                               table_width=FIG12_ARENA // 2,
                               block_size=FIG12_BLOCK))):
        h, kv, hd = heads
        q, kp, vp, bt, lens, pages = decode_inputs(torch, dev, gen, q_dtype,
                                                   kv_dtype, heads, **rows)
        got = ops.paged_decode_attention(q, kp, vp, bt, lens)
        want = ops.paged_decode_attention_plain(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = tolerance(name, want)
        bits = same_bits(torch, lambda: ops.paged_decode_attention(
            q, kp, vp, bt, lens))
        n_pos = int(lens.sum())
        nbytes = (2 * n_pos * kv * hd * kp.element_size()
                  + 2 * q.numel() * q.element_size()
                  + 4 * (sum(pages) + B))
        flops = 4.0 * n_pos * h * hd
        bnd, by = bound_ms(nbytes, flops, "float32" if name == "float32"
                           else "bfloat16")
        ms, host_ms_k = cuda_ms(torch, lambda: ops.paged_decode_attention(
            q, kp, vp, bt, lens), reps=20, flush=flush)
        plain_ms, _ = cuda_ms(torch, lambda: ops.paged_decode_attention_plain(
            q, kp, vp, bt, lens), reps=5, flush=flush)
        library_ms, _ = cuda_ms(torch, lambda: library_attention(
            torch, q, kp, vp, bt, lens, max(pages)), reps=10, flush=flush)
        case = {
            "case": name, "heads": list(heads),
            "variant": tda.variant(q_dtype, hd),
            "table_width": bt.shape[1], "block_size": kp.shape[1],
            "max_abs_err": err,
            "tol": tol, "same_bits": bits, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "read_ms": read_ms(torch, nbytes, flush),
            "bound_ms": bnd, "bound_by": by, "kv_bytes": nbytes,
            "host_call_ms": host_ms_k, "lens": lens.tolist(),
        }
        cases.append(case)
        print(f"kernel paged_decode_attention[{name}] ({case['variant']}): "
              f"max_abs_err={err:.3e} (tol {tol:g}) same_bits={bits} "
              f"ms={case['ms']:.4f} plain_ms={case['plain_ms']:.4f} "
              f"library_ms(gather+sdpa)={case['library_ms']:.4f} "
              f"read_ms={case['read_ms']:.4f} "
              f"bound_ms={bnd:.4f} ({by}, {nbytes} B) "
              f"host_call_ms={host_ms_k:.4f}", flush=True)
        check(err <= tol, f"paged_decode_attention[{name}] error "
              f"{err} > {tol}")
        check(bits or q_dtype != torch.bfloat16, f"paged_decode_attention["
              f"{name}] gave other bits on a second call")
        if fold:
            folded.append(paged_fold_case(torch, gen, flush, name, q, kp, vp,
                                          bt, lens, pages))
        del q, kp, vp, bt, lens, got, want

    # the paged KV append: one layer's arena, 8 rows, the last out of range
    k_pages = torch.randn(N_BLOCKS, BS, KV, HD, generator=gen,
                          device=dev).to(torch.bfloat16)
    slots = torch.randperm(N_BLOCKS * BS, generator=gen, device=dev)[:B]
    slots[-1] = N_BLOCKS * BS + 5
    append = append_case(torch, gen, flush, "paged-bfloat16", k_pages,
                         slots.to(torch.int32))
    return cases, folded, append


def fold_case(torch, flush, kernel: str, label: str, name: str, *, run,
              plain, two_call, arenas, variant: str, nbytes: int,
              flops: float) -> dict:
    """One case of K1 or K2 as a decode step calls it: ``run(k, v,
    shift)`` launches the kernel that writes the step's new token into
    the cache ``k, v`` (at its slots moved on by ``shift``) and attends it,
    ``plain(k, v)`` is its plain version (the reference's two calls), and
    ``two_call(k, v)`` the same two calls through the kernels (the append
    kernel and K1 or K2). Each runs on its own copy of ``arenas``: the
    output is held to the case's tolerance and the cache, bytes and all,
    to the plain append's, two calls give the same bits, and a control
    (every slot one on) must fail. Timed against the two kernel calls,
    the plain version and the bound (no one library call appends and
    attends)."""
    k0, v0 = arenas
    kk, vk = k0.clone(), v0.clone()
    kp, vp = k0.clone(), v0.clone()
    got = run(kk, vk, 0)
    want = plain(kp, vp)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = tolerance(name, want)
    same_cache = bool(torch.equal(kk, kp) and torch.equal(vk, vp))
    bits = same_bits(torch, lambda: run(kk, vk, 0))
    same_cache = same_cache and bool(torch.equal(kk, kp)
                                     and torch.equal(vk, vp))
    kc, vc = k0.clone(), v0.clone()
    ctrl = run(kc, vc, 1)
    torch.cuda.synchronize()
    ctrl_err = (ctrl.float() - want.float()).abs().max().item()
    ctrl_passes = bool(ctrl_err <= tol and torch.equal(kc, kp)
                       and torch.equal(vc, vp))
    del kc, vc, ctrl
    bnd, by = bound_ms(nbytes, flops, "float32" if name == "float32"
                       else "bfloat16")
    ms, host_k = cuda_ms(torch, lambda: run(kk, vk, 0), reps=20, flush=flush)
    two_ms, host_two = cuda_ms(torch, lambda: two_call(kk, vk), reps=20,
                               flush=flush)
    plain_ms, _ = cuda_ms(torch, lambda: plain(kp, vp), reps=5, flush=flush)
    case = {"case": f"{label}-fused", "variant": variant,
            "max_abs_err": err, "tol": tol, "same_cache": same_cache,
            "same_bits": bits, "control_err": ctrl_err,
            "control_passes": ctrl_passes, "ms": ms, "two_call_ms": two_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bnd,
            "bound_by": by, "kv_bytes": nbytes, "host_call_ms": host_k,
            "two_call_host_ms": host_two}
    print(f"kernel {kernel}[{case['case']}] ({variant}, appends and "
          f"attends): max_abs_err={err:.3e} (tol {tol:g}) cache bit-equal "
          f"to the plain append={same_cache} same_bits={bits} "
          f"ms={ms:.4f} two_call_ms(append + attend)={two_ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bnd:.6f} ({by}, {nbytes} B) "
          f"host_call_ms={host_k:.4f} two_call_host_ms={host_two:.4f}; "
          f"control (slots one on): err {ctrl_err:.3e}, passes="
          f"{ctrl_passes}", flush=True)
    check(err <= tol, f"{kernel}[{case['case']}] error {err} > {tol}")
    check(same_cache, f"{kernel}[{case['case']}] wrote other cache bytes "
          f"than the plain append")
    check(bits or name == "float32", f"{kernel}[{case['case']}] gave "
          f"other bits on a second call")
    check(not ctrl_passes, f"{kernel}[{case['case']}]: the control with "
          f"shifted slots passed")
    return case


def token_slots(torch, bt, cached, block_size=BS):
    """Each row's flat arena slot for the step's token at position
    ``cached[b]`` of its block table (``layers.paged_step``'s rule)."""
    pos = cached.long()
    rows = torch.arange(bt.shape[0], device=bt.device)
    return (bt[rows, pos // block_size].long() * block_size
            + pos % block_size).to(torch.int32)


def paged_fold_case(torch, gen, flush, name, q, kp, vp, bt, lens,
                    pages) -> dict:
    """K1 with the step's token on phase 2's inputs: each row holds
    lens - 1 cached positions and its token goes to position lens - 1 of
    its table (so as many positions are attended as in the case without
    it); the last row's slot is out of range, and its position already
    holds its token, as if an earlier step had written it, so the
    dropped write leaves both forms attending the same token."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import ops

    b_, h, hd = q.shape
    bs, kv = kp.shape[1:3]
    n_slots = kp.shape[0] * bs
    cached = lens - 1
    slots = token_slots(torch, bt, cached, bs)
    k_new, v_new = (torch.randn(b_, kv, hd, generator=gen, device=q.device)
                    .to(q.dtype) for _ in range(2))
    last = slots[-1].long()
    kp.view(n_slots, kv, hd)[last] = ops.quantise_kv(k_new[-1], kp.dtype)
    vp.view(n_slots, kv, hd)[last] = ops.quantise_kv(v_new[-1], vp.dtype)
    slots[-1] = n_slots + 5
    kq, vq = ops.quantise_kv(k_new, kp.dtype), ops.quantise_kv(v_new, kp.dtype)
    lens1 = cached + 1

    def run(k, v, shift):
        return ops.paged_decode_attention(q, k, v, bt, cached, k_new, v_new,
                                          slots + shift if shift else slots)

    def two_call(k, v):
        ops.update_kv_buffer(k, v, kq, vq, slots)
        return ops.paged_decode_attention(q, k, v, bt, lens1)

    n_pos = int(cached.sum())
    row = kv * hd
    nbytes = (2 * n_pos * row * kp.element_size()
              + 2 * q.numel() * q.element_size() + 4 * (sum(pages) + b_)
              + 2 * b_ * row * q.element_size() + 4 * b_
              + 2 * (b_ - 1) * row * kp.element_size())
    return fold_case(
        torch, flush, "paged_decode_attention", name, name, run=run,
        plain=lambda k, v: ops.paged_decode_attention_plain(
            q, k, v, bt, cached, k_new, v_new, slots),
        two_call=two_call, arenas=(kp, vp),
        variant=tda.variant(q.dtype, hd), nbytes=nbytes,
        flops=4.0 * (n_pos + b_) * h * hd)


def append_case(torch, gen, flush, label, k_pages, slots) -> dict:
    """The KV append into ``k_pages``/``v_pages`` [NB,BS,KV,hd] (a random
    ``v_pages`` like ``k_pages``) of one new row per slot, against its plain
    version (equal bit for bit; a slot out of range is dropped), timed
    against the plain version, ``index_copy_`` of the in-range rows as the
    library yardstick, and the bytes bound."""
    from repro_torch.kernels import ops

    NB, bs, kv, hd = k_pages.shape
    rows = slots.shape[0]
    dev = k_pages.device
    v_pages = torch.randn(k_pages.shape, generator=gen, device=dev).to(
        k_pages.dtype)
    k_new, v_new = (torch.randn(rows, kv, hd, generator=gen, device=dev)
                    .to(k_pages.dtype) for _ in range(2))
    k2, v2 = k_pages.clone(), v_pages.clone()
    ops.update_kv_buffer(k_pages, v_pages, k_new, v_new, slots)
    ops.update_kv_buffer_plain(k2, v2, k_new, v_new, slots)
    torch.cuda.synchronize()
    err = max((k_pages.float() - k2.float()).abs().max().item(),
              (v_pages.float() - v2.float()).abs().max().item())
    keep = slots < NB * bs
    valid, n_valid = slots[keep].long(), int(keep.sum())
    nbytes = 4 * n_valid * kv * hd * k_pages.element_size() + 4 * rows
    kf, vf = k_pages.view(-1, kv, hd), v_pages.view(-1, kv, hd)

    def library_append():   # yardstick: index_copy_ of the in-range rows
        kf.index_copy_(0, valid, k_new[keep])
        vf.index_copy_(0, valid, v_new[keep])

    bnd, by = bound_ms(nbytes, 0.0, "bfloat16")
    ms, host_ms_a = cuda_ms(torch, lambda: ops.update_kv_buffer(
        k_pages, v_pages, k_new, v_new, slots), reps=50, flush=flush)
    plain_ms, _ = cuda_ms(torch, lambda: ops.update_kv_buffer_plain(
        k_pages, v_pages, k_new, v_new, slots), reps=20, flush=flush)
    library_ms, _ = cuda_ms(torch, library_append, reps=50, flush=flush)
    case = {
        "case": f"{label}-rows{rows}-KV{kv}-hd{hd}", "max_abs_err": err,
        "tol": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bnd, "bound_by": by, "kv_bytes": nbytes,
        "host_call_ms": host_ms_a,
    }
    print(f"kernel update_kv_buffer[{case['case']}]: max_abs_err={err:.3e} "
          f"(tol 0, {rows - n_valid} out-of-range slot(s) dropped) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms(index_copy_)={library_ms:.4f} "
          f"bound_ms={bnd:.6f} ({by}, {nbytes} B) "
          f"host_call_ms={host_ms_a:.4f}", flush=True)
    check(err == 0.0, f"update_kv_buffer[{case['case']}] differs from "
          f"plain: {err}")
    return case


# ------------------------------------------ phase 2b: the dense kernel --

def dense_inputs(torch, dev, gen, q_dtype, kv_dtype, *, b, s, max_len, heads):
    """q [b,h,hd], a carried-layout cache k/v [b,s,kv,hd], ragged lens (row
    0 at max_len) and a new token k_new/v_new [b,kv,hd] in q's dtype, for
    ``heads`` = (h, kv, hd)."""
    h, kv, hd = heads
    lens = torch.randint(1, max_len + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[0] = max_len
    q = torch.randn(b, h, hd, generator=gen, device=dev).to(q_dtype)
    shape = (b, s, kv, hd)
    if kv_dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
    k_new = torch.randn(b, kv, hd, generator=gen, device=dev).to(q_dtype)
    v_new = torch.randn(b, kv, hd, generator=gen, device=dev).to(q_dtype)
    return q, k, v, lens, k_new, v_new


def library_dense_attention(torch, q, k, v, lens):
    """Yardstick only, never on the path: one masked
    F.scaled_dot_product_attention call over the cache (GQA by
    enable_gqa; an int8 cache dequantised first)."""
    F = torch.nn.functional
    if k.dtype == torch.int8:
        k, v = k.to(q.dtype) / 16.0, v.to(q.dtype) / 16.0
    mask = (torch.arange(k.shape[1], device=q.device)[None]
            < lens[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)[:, :, 0]


def dense_kernel_phase(torch, dev, flush, hybrid, moe, seamless,
                       fold: bool = True):
    """K2 against its plain version at starcoder2's shapes, at the
    hybrid's shared attention (``hybrid`` = (H, KV, hd), G = 1, hd 80), at
    the MoE model's attention (``moe``, G = 1, hd 128) and at seamless's
    decoder (``seamless``, G = 1, hd 64), with ``fold`` each shape again as
    the decode step calls K2, appending the step's token in the same
    launch (:func:`dense_fold_case`), and the KV append alone at the
    hybrid's dense cache. Returns (K2's cases, the fused cases, the
    append's cases)."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    dtypes = (("bfloat16", torch.bfloat16, torch.bfloat16),
              ("float32", torch.float32, torch.float32),
              ("int8", torch.bfloat16, torch.int8))
    heads = (H, KV, HD)
    # (label, rows, cache positions, largest len, heads): the kernel
    # check's sizes; a cache of 1000 positions (1000 % 512 and 1000 % 64
    # are not 0) with a row past capacity; the bucketed serve loop's
    # shape; the eager serve loop's row (the launcher's cache of 256);
    # then the hybrid's decode, eager (one row, bf16, and f32 as phase
    # 10's decode against prefill runs it) and bucketed; the MoE model's;
    # seamless's decoder row
    shapes = [("S4096", B, MAX_LEN, MAX_LEN, heads, d) for d in dtypes]
    shapes += [("S1000-tail", B, 1000, 1005, heads, dtypes[0]),
               ("bucket8-S256", 8, DENSE_LEN, 40, heads, dtypes[0]),
               ("B1-S256", 1, DENSE_LEN, DENSE_LEN, heads, dtypes[0]),
               ("hybrid-B1-S256", 1, DENSE_LEN, DENSE_LEN, hybrid, dtypes[0]),
               ("hybrid-B1-S256", 1, DENSE_LEN, DENSE_LEN, hybrid, dtypes[1]),
               ("hybrid-bucket8-S256", 8, DENSE_LEN, 40, hybrid, dtypes[0]),
               ("moe-B1-S256", 1, DENSE_LEN, DENSE_LEN, moe, dtypes[0]),
               ("moe-bucket8-S256", 8, DENSE_LEN, 40, moe, dtypes[0]),
               ("seamless-B1-S256", 1, DENSE_LEN, DENSE_LEN, seamless,
                dtypes[0])]
    cases, folded = [], []
    for label, b, s, max_len, (h, kv, hd), (name, q_dtype, kv_dtype) \
            in shapes:
        q, k, v, lens, k_new, v_new = dense_inputs(
            torch, dev, gen, q_dtype, kv_dtype, b=b, s=s, max_len=max_len,
            heads=(h, kv, hd))
        n_pos = int(lens.clamp(max=s).sum())
        for new in (False, True):
            extra = (k_new, v_new) if new else ()
            got = ops.decode_attention(q, k, v, lens, *extra)
            want = ops.decode_attention_plain(q, k, v, lens, *extra)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = tolerance(name, want)
            bits = same_bits(torch, lambda: ops.decode_attention(
                q, k, v, lens, *extra))
            nbytes = (2 * n_pos * kv * hd * k.element_size()
                      + 2 * q.numel() * q.element_size() + 4 * b
                      + (2 * k_new.numel() * k_new.element_size()
                         if new else 0))
            flops = 4.0 * (n_pos + (b if new else 0)) * h * hd
            bnd, by = bound_ms(nbytes, flops, "float32" if name == "float32"
                               else "bfloat16")
            ms, host_ms_k = cuda_ms(torch, lambda: ops.decode_attention(
                q, k, v, lens, *extra), reps=20, flush=flush)
            plain_ms, _ = cuda_ms(torch, lambda: ops.decode_attention_plain(
                q, k, v, lens, *extra), reps=5, flush=flush)
            library_ms = None
            if not new:     # one library call computes the same function
                library_ms, _ = cuda_ms(torch, lambda: library_dense_attention(
                    torch, q, k, v, lens), reps=10, flush=flush)
            case = {
                "case": f"{label}-{name}-{'new' if new else 'cache'}",
                "heads": [h, kv, hd], "variant": tda.variant(q_dtype, hd),
                "max_abs_err": err, "tol": tol, "same_bits": bits, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "read_ms": read_ms(torch, nbytes, flush),
                "bound_ms": bnd, "bound_by": by, "kv_bytes": nbytes,
                "host_call_ms": host_ms_k, "lens": lens.tolist(),
            }
            cases.append(case)
            lib = "null" if library_ms is None else f"{library_ms:.4f}"
            print(f"kernel decode_attention[{case['case']}] "
                  f"({case['variant']}): max_abs_err={err:.3e} (tol {tol:g}) "
                  f"same_bits={bits} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms(sdpa)={lib} read_ms={case['read_ms']:.4f} "
                  f"bound_ms={bnd:.4f} ({by}, {nbytes} B) "
                  f"host_call_ms={host_ms_k:.4f}", flush=True)
            check(err <= tol, f"decode_attention[{case['case']}] error "
                  f"{err} > {tol}")
            check(bits or q_dtype != torch.bfloat16, f"decode_attention["
                  f"{case['case']}] gave other bits on a second call")
        if fold:
            folded.append(dense_fold_case(torch, flush, f"{label}-{name}",
                                          name, q, k, v, lens, k_new, v_new))
        del q, k, v, lens, k_new, v_new, got, want
    # the hybrid's KV append: a bucket's cache of one application of the
    # shared block (slots as layers.dense_step makes them; one row at
    # capacity, whose write is dropped), and one row in f32 as phase 10's
    # decode against prefill writes it
    appends = []
    _, kv, hd = hybrid
    for b, dtype, name in ((8, torch.bfloat16, "bfloat16"),
                           (1, torch.float32, "float32")):
        kc = torch.randn(b, DENSE_LEN, kv, hd, generator=gen,
                         device=dev).to(dtype)
        lens = torch.randint(0, 40, (b,), generator=gen, device=dev)
        if b > 1:
            lens[-1] = DENSE_LEN
        rows = torch.arange(b, device=dev)
        slots = torch.where(lens < DENSE_LEN, rows * DENSE_LEN + lens,
                            b * DENSE_LEN).to(torch.int32)
        appends.append(append_case(torch, gen, flush, f"hybrid-{name}", kc,
                                   slots))
        del kc
    return cases, folded, appends


def dense_fold_case(torch, flush, label, name, q, k, v, lens, k_new,
                    v_new) -> dict:
    """K2 with the step's token on phase 2b's inputs: each row holds
    min(lens - 1, S - 1) cached positions and its token is written after
    them (so as many positions are attended as in the case with the new
    token); in a case of several rows the last is full, at S cached
    positions, and its write is dropped (``layers.dense_step``'s slot B *
    S)."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import ops

    b_, s, kv, hd = k.shape
    h = q.shape[1]
    cached = (lens - 1).clamp(0, s - 1)
    if b_ > 1:
        cached[-1] = s
    rows = torch.arange(b_, device=q.device)
    slots = torch.where(cached < s, rows * s + cached, b_ * s).to(torch.int32)
    kq, vq = ops.quantise_kv(k_new, k.dtype), ops.quantise_kv(v_new, k.dtype)

    def run(kc, vc, shift):
        return ops.decode_attention(q, kc, vc, cached, k_new, v_new,
                                    slots + shift if shift else slots)

    def two_call(kc, vc):
        out = ops.decode_attention(q, kc, vc, cached, k_new, v_new)
        ops.update_kv_buffer(kc, vc, kq, vq, slots)
        return out

    n_pos = int(cached.clamp(max=s).sum())
    n_in = int((cached < s).sum())
    row = kv * hd
    nbytes = (2 * n_pos * row * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * b_
              + 2 * b_ * row * q.element_size() + 4 * b_
              + 2 * n_in * row * k.element_size())
    return fold_case(
        torch, flush, "decode_attention", label, name, run=run,
        plain=lambda kc, vc: ops.decode_attention_plain(
            q, kc, vc, cached, k_new, v_new, slots),
        two_call=two_call, arenas=(k, v), variant=tda.variant(q.dtype, hd),
        nbytes=nbytes, flops=4.0 * (n_pos + b_) * h * hd)


# ---------------------------------------------------- phase 3: main path --

def make_requests(rng, vocab: int):
    """16 ``[budget, tag, prompt...]`` requests, prompts of 16-256 tokens,
    budgets 8-32; tags 100 and 101 share a 64-token prefix (101 is sent
    once 100 is answered, so its prefix blocks are sealed)."""
    prefix = rng.integers(1, vocab, size=64).tolist()
    reqs = []
    for i in range(16):
        budget = int(rng.integers(8, 33))
        if i < 2:
            prompt = prefix + rng.integers(1, vocab, size=16 + 8 * i).tolist()
        else:
            prompt = rng.integers(1, vocab,
                                  size=int(rng.integers(16, 257))).tolist()
        reqs.append([budget, 100 + i] + prompt)
    return reqs


def serve_main_path(cfg, params, *, n_slots, n_blocks, reqs, spill_path,
                    counters):
    """Serve ``reqs`` over UDP through GenesysUdpServer(use_tenants=True)
    and the continuous engine; ``counters`` are zeroed right before the
    serve loop starts. Returns (replies {tag: tokens}, engine, stats,
    wall_s, step_s list)."""
    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.serving.engine import make_engine
    from repro_torch.serving.server import GenesysUdpServer

    gsys = Genesys(GenesysConfig(n_workers=2, sched_pollers=2,
                                 ring_spin_polls=POLLER_SPIN,
                                 ring_max_sleep_s=POLLER_MAX_SLEEP_S))
    try:
        eng = make_engine(cfg, params, n_slots=n_slots, n_blocks=n_blocks,
                          block_size=BS, gsys=gsys, spill_path=spill_path)
        step_s = []
        inner = eng.serve_step

        def timed_step(*args):      # the step ends in a device->host copy
            t0 = time.perf_counter()
            out = inner(*args)
            step_s.append(time.perf_counter() - t0)
            return out
        eng.serve_step = timed_step
        srv = GenesysUdpServer(gsys, port=0, use_tenants=True)
        port = gsys.table._sockets[srv.fd].getsockname()[1]
        client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        client.bind(("127.0.0.1", 0))
        client.settimeout(120)
        result = {}

        def serve():
            result["stats"] = srv.serve_model_continuous(
                eng, reply_port=client.getsockname()[1],
                n_requests=len(reqs), max_idle_polls=400)

        zero_counts(counters)
        th = threading.Thread(target=serve, name="smoke-serve", daemon=True)
        t0 = time.perf_counter()
        th.start()
        time.sleep(0.05)
        late = reqs[1]                    # shares request 0's prefix
        for r in reqs:
            if r is not late:
                client.sendto(_dgram(r), ("127.0.0.1", port))
        replies = {}
        try:
            while len(replies) < len(reqs):
                data, _ = client.recvfrom(65536)
                tag, *gen = _tokens(data)
                replies[tag] = gen
                if tag == reqs[0][1]:
                    client.sendto(_dgram(late), ("127.0.0.1", port))
        finally:
            client.close()
        th.join(120)
        wall = time.perf_counter() - t0
        check(not th.is_alive(), "serve loop did not stop")
        srv.close()
        sched = gsys.sched.counters.snapshot()
        print(f"host plane pollers: rounds={sched['rounds']} idle_rounds="
              f"{sched['idle_rounds']} parks={sched['parks']} wakeups="
              f"{sched['wakeups']} served_entries={sched['served_entries']}",
              flush=True)
        return replies, eng, result["stats"], wall, step_s
    finally:
        gsys.shutdown()


def _dgram(req) -> bytes:
    import numpy as np
    return np.asarray(req, np.int32).tobytes()


def _tokens(data: bytes) -> list[int]:
    import numpy as np
    return np.frombuffer(data, np.int32).tolist()


def check_replies(reqs, replies, vocab: int) -> None:
    for budget, tag, *_ in reqs:
        check(tag in replies, f"tag {tag} not answered")
        gen = replies[tag]
        check(len(gen) == budget, f"tag {tag}: {len(gen)} tokens, budget "
              f"{budget}")
        check(all(0 <= t < vocab for t in gen), f"tag {tag}: token ids out "
              f"of range: {gen}")


def main_path_run(torch, cfg, params, *, n_blocks: int,
                  per_layer: dict) -> dict:
    """Phases 3 and 15: phase 3's 16 requests through the paged engine (8
    slots, ``n_blocks`` blocks, a spill file): every reply carries its
    budget, the shared prefix hits, and each kernel wrapper of
    ``per_layer`` ({wrapper: launches per layer and step}) launched as
    many times, every K1 launch appending the step's token (no launch of
    the append alone). An MoE model's capacity drops are counted on the
    device and read once, at the end. Returns the run's numbers."""
    import numpy as np

    from repro_torch.config import Family
    from repro_torch.models import moe

    reqs = make_requests(np.random.default_rng(0), cfg.vocab_size)
    counters = tuple(per_layer)
    with moe.CountDrops() as counted, tempfile.TemporaryDirectory() as tmp:
        replies, eng, stats, wall, step_s = serve_main_path(
            cfg, params, n_slots=B, n_blocks=n_blocks, reqs=reqs,
            spill_path=str(Path(tmp) / "kv.spill"), counters=counters)
    launches = read_counts(counters)
    steps = eng.stats.steps
    out = {"arch": cfg.arch_id, "steps": steps,
           "tokens_out": stats.tokens_out, "wall_s": wall,
           "tokens_per_s": stats.tokens_out / wall,
           "mean_step_ms": 1e3 * statistics.mean(step_s),
           "median_step_ms": 1e3 * statistics.median(step_s),
           "occupancy": eng.stats.occupancy(),
           "prefix_hits": eng.pool.stats.prefix_hits,
           "prefill_saved": eng.stats.prefill_steps_saved,
           "arena_bytes": sum(a.numel() * a.element_size()
                              for a in eng.arenas.values()),
           "launches": launches}
    drops = ""
    if cfg.family == Family.MOE:
        out["dropped"] = counted.read()   # the one read of the count
        out["assignments"] = steps * B * cfg.top_k * cfg.n_layers
        drops = (f"; capacity dropped {out['dropped']} of "
                 f"{out['assignments']} token-expert assignments (inactive "
                 f"slots included)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"main path {cfg.arch_id}: {len(replies)} requests answered with "
          f"their budgets, tokens_out={out['tokens_out']} wall={wall:.3f} s "
          f"tokens/s={out['tokens_per_s']:.1f} steps={steps} "
          f"mean_step_ms={out['mean_step_ms']:.3f} "
          f"median_step_ms={out['median_step_ms']:.3f} "
          f"occupancy={out['occupancy']:.2f} "
          f"prefix_hits={out['prefix_hits']} "
          f"prefill_saved={out['prefill_saved']} "
          f"arena={out['arena_bytes'] / 1e9:.2f} GB{drops}; "
          f"launches={launches}", flush=True)
    check_replies(reqs, replies, cfg.vocab_size)
    check(out["prefix_hits"] > 0, f"{cfg.arch_id}: the shared prefix never "
          f"hit")
    for f, per in per_layer.items():
        want = per * cfg.n_layers * steps
        check(launches[f.__name__] == want, f"{cfg.arch_id}: {f.__name__} "
              f"launched {launches[f.__name__]} times, expected {want}")
    check(launches["paged_decode_attention_fused"]
          == launches["paged_decode_attention"], f"{cfg.arch_id}: "
          f"{launches['paged_decode_attention_fused']} of "
          f"{launches['paged_decode_attention']} K1 launches appended")
    check(all(np.isfinite(step_s)), "step times")
    return out


# ------------------------------------------------ phase 5: dense path ---

def make_dense_requests(rng, vocab: int):
    """16 prompts of 16-256 tokens with distinct last tokens, and budgets
    8-32 for the bucketed run's ``[budget, tag, prompt...]`` form."""
    import numpy as np
    last = rng.choice(np.arange(1, vocab), size=N_DENSE_REQS, replace=False)
    prompts = [rng.integers(1, vocab, size=int(n)).tolist() + [int(t)]
               for n, t in zip(rng.integers(15, 256, size=N_DENSE_REQS),
                               last)]
    budgets = [int(b) for b in rng.integers(8, 33, size=N_DENSE_REQS)]
    return prompts, budgets


def serve_dense(torch, cfg, params, mode, reqs, *, max_tokens, counters):
    """Serve ``reqs`` over UDP on the dense path: ``mode`` "eager" or
    "bucketed" through GenesysUdpServer(use_tenants=True).serve_model, or
    "cpu" through CpuBaselineUdpServer.serve_model; ``counters`` are
    zeroed right before the loop starts. Returns (replies in arrival
    order, stats, wall_s, step_s list)."""
    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.models.registry import get_api
    from repro_torch.serving.server import (
        CpuBaselineUdpServer, GenesysUdpServer,
    )
    from repro_torch.train.steps import make_serve_step

    inner = make_serve_step(cfg)
    step_s = []

    def serve_fn(*args):        # the loop reads the tokens back anyway
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    cache = get_api(cfg).init_cache(cfg, 1, DENSE_LEN,
                                    device=params["embed"].device)
    gsys = None
    if mode == "cpu":
        srv = CpuBaselineUdpServer(port=0)
        port = srv.sock.getsockname()[1]
    else:
        gsys = Genesys(GenesysConfig(n_workers=2, sched_pollers=2,
                                     ring_spin_polls=POLLER_SPIN,
                                     ring_max_sleep_s=POLLER_MAX_SLEEP_S))
        srv = GenesysUdpServer(gsys, port=0, use_tenants=True)
        port = gsys.table._sockets[srv.fd].getsockname()[1]
    try:
        client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        client.bind(("127.0.0.1", 0))
        client.settimeout(120)
        reply_port = client.getsockname()[1]
        result = {}

        def serve():
            if mode == "cpu":
                result["stats"] = srv.serve_model(
                    serve_fn, params, cache, n_batches=len(reqs),
                    reply_port=reply_port, max_tokens=max_tokens)
            else:
                result["stats"] = srv.serve_model(
                    serve_fn, params, cache, n_batches=len(reqs),
                    n_requests=len(reqs), max_idle_polls=400,
                    reply_port=reply_port, max_tokens=max_tokens,
                    batch_decode=mode == "bucketed",
                    per_request_tokens=mode == "bucketed")

        zero_counts(counters)
        th = threading.Thread(target=serve, name=f"smoke-{mode}",
                              daemon=True)
        t0 = time.perf_counter()
        th.start()
        time.sleep(0.05)
        for r in reqs:
            client.sendto(_dgram(r), ("127.0.0.1", port))
        replies = []
        try:
            while len(replies) < len(reqs):
                data, _ = client.recvfrom(65536)
                replies.append(_tokens(data))
        finally:
            client.close()
        th.join(120)
        wall = time.perf_counter() - t0
        check(not th.is_alive(), f"{mode} serve loop did not stop")
        return replies, result["stats"], wall, step_s
    finally:
        srv.close()
        if gsys is not None:
            gsys.shutdown()


def attention_layers(cfg) -> int:
    """The attention layers one token passes: every layer of a
    transformer, the shared block's applications in the hybrid, none in
    rwkv6."""
    from repro_torch.config import Family
    from repro_torch.models import mamba2
    if cfg.family == Family.SSM:
        return 0
    return (mamba2.n_shared_applications(cfg)
            if cfg.family == Family.HYBRID else cfg.n_layers)


def dense_path_phase(torch, cfg, params):
    """Phase 5 (and 10, 13, 16): the three dense servers at full width.
    Returns a dict of per-run results and K2's launches per run: once per
    attention layer and dispatch, each appending the step's token (no
    launch of the append alone). An MoE model also launches K6 three times
    per layer and dispatch, and counts the assignments its capacity drops
    (none in a one-row step)."""
    import numpy as np

    from repro_torch.config import Family
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    prompts, budgets = make_dense_requests(np.random.default_rng(5),
                                           cfg.vocab_size)
    tagged = [[b, 300 + i] + p
              for i, (b, p) in enumerate(zip(budgets, prompts))]
    counters = (ops.decode_attention, ops.update_kv_buffer,
                ops.paged_decode_attention, ops.mamba2_ssd_fwd,
                ops.rwkv6_wkv_fwd, ops.gmm_fwd)
    n_attn = attention_layers(cfg)
    n_gmm = 3 * cfg.n_layers if cfg.family == Family.MOE else 0
    runs = {}
    for mode, reqs, max_tokens in (("eager", prompts, EAGER_TOKENS),
                                   ("bucketed", tagged, max(budgets)),
                                   ("cpu", prompts, EAGER_TOKENS)):
        with moe.CountDrops() as drops:
            replies, stats, wall, step_s = serve_dense(
                torch, cfg, params, mode, reqs, max_tokens=max_tokens,
                counters=counters)
        n_dropped = drops.read()
        launches = read_counts(counters)
        dispatches = len(step_s)
        if mode == "bucketed":
            got = {r[0]: r[1:] for r in replies}
            for budget, tag, *_ in reqs:
                check(len(got.get(tag, ())) == budget, f"bucketed tag "
                      f"{tag}: {len(got.get(tag, ()))} tokens, budget "
                      f"{budget}")
            gens = list(got.values())
        else:
            gens = replies
            check(all(len(g) == max_tokens for g in gens),
                  f"{mode}: a reply without its {max_tokens} tokens")
        check(all(0 <= t < cfg.vocab_size for g in gens for t in g),
              f"{mode}: token ids out of range")
        tokens = sum(len(g) for g in gens)
        if mode != "cpu":
            check(stats.decode_dispatches == dispatches,
                  f"{mode}: {stats.decode_dispatches} dispatches counted, "
                  f"{dispatches} made")
        for name in ("decode_attention", "decode_attention_fused"):
            check(launches[name] == n_attn * dispatches,
                  f"{mode}: {name} launched {launches[name]} times, "
                  f"expected {n_attn} x {dispatches} dispatches")
        check(launches["update_kv_buffer"] == 0, f"{mode}: the append "
              f"launched alone {launches['update_kv_buffer']} times")
        check(launches["paged_decode_attention"] == 0
              and launches["mamba2_ssd_fwd"] == 0
              and launches["rwkv6_wkv_fwd"] == 0,
              f"{mode}: the paged kernel or a scan ran on the dense path")
        check(launches["gmm_fwd"] == n_gmm * dispatches,
              f"{mode}: gmm_fwd launched {launches['gmm_fwd']} times, "
              f"expected {n_gmm} x {dispatches} dispatches")
        check(mode == "bucketed" or n_dropped == 0, f"{mode}: a one-row "
              f"step dropped {n_dropped} assignments")
        run = {"replies": gens, "tokens_out": tokens, "wall_s": wall,
               "tokens_per_s": tokens / wall, "dispatches": dispatches,
               "mean_step_ms": 1e3 * statistics.mean(step_s),
               "median_step_ms": 1e3 * statistics.median(step_s),
               "launches": launches["decode_attention"],
               "fused_launches": launches["decode_attention_fused"],
               "append_launches": launches["update_kv_buffer"],
               "gmm_launches": launches["gmm_fwd"], "dropped": n_dropped}
        runs[mode] = run
        print(f"dense path {cfg.arch_id} [{mode}]: {len(reqs)} requests "
              f"answered with their budgets, tokens_out={tokens} "
              f"wall={wall:.3f} s "
              f"tokens/s={run['tokens_per_s']:.1f} dispatches={dispatches} "
              f"mean_step_ms={run['mean_step_ms']:.3f} "
              f"median_step_ms={run['median_step_ms']:.3f} "
              f"launches={launches} dropped={n_dropped}", flush=True)
    check(sorted(runs["eager"]["replies"]) == sorted(runs["cpu"]["replies"]),
          "GENESYS eager and the CPU baseline returned different tokens")
    # bucketed rows decode in a batch of 8 (other bf16 GEMM shapes, and an
    # MoE capacity shared by the bucket), so their tokens may part from
    # eager's at a near tie: reported, not gated (phase 16 holds an MoE
    # bucket's logits to its rows alone where it drops nothing)
    eager_by_first = {tuple(g[:8]) for g in runs["eager"]["replies"]}
    same = sum(tuple(g[:8]) in eager_by_first
               for g in runs["bucketed"]["replies"])
    print(f"dense path {cfg.arch_id}: eager == cpu baseline on all "
          f"{N_DENSE_REQS} replies; bucketed first 8 tokens equal eager's "
          f"on {same}/"
          f"{N_DENSE_REQS}", flush=True)
    for run in runs.values():
        del run["replies"]
    # the step alone at the eager and the bucketed shape, the host
    # plane's threads stopped: host clock vs device busy time
    for mode, rows in (("eager", 1), ("bucketed", 8)):
        runs[mode].update(dense_step_alone(torch, cfg, params, rows))
    return runs


def dense_step_alone(torch, cfg, params, rows: int) -> dict:
    """One dense step of ``rows`` rows over the 256-position cache at
    cached length 128: host ms (ends in a sync) and device busy ms."""
    from repro_torch.models.registry import get_api
    from repro_torch.train.steps import make_serve_step
    step = make_serve_step(cfg)
    cache = get_api(cfg).init_cache(cfg, rows, DENSE_LEN, device="cuda")
    tok = torch.ones((rows, 1), dtype=torch.int32, device="cuda")
    cl = torch.full((rows,), 128, dtype=torch.int32, device="cuda")

    def one_step():
        step(params, cache, tok, cl)
    alone_ms = host_ms(torch, one_step, reps=10)
    busy_ms = device_busy_ms(torch, one_step, top=8)
    busy = "not measured" if busy_ms is None else f"{busy_ms:.3f}"
    print(f"dense step alone {cfg.arch_id} ({rows} row(s), cached len "
          f"128): host_ms={alone_ms:.3f} device_busy_ms={busy} "
          f"device_ops={device_busy_ms.ops}", flush=True)
    host_ops(torch, one_step, top=8)
    return {"step_alone_ms": alone_ms, "step_device_busy_ms": busy_ms,
            "step_device_ops": device_busy_ms.ops}


def host_ops(torch, fn, top: int) -> None:
    """Print the ``top`` operators of one call of ``fn`` by host (CPU)
    time, from torch.profiler; the profiler's own cost inflates every
    entry, so the order is what it shows."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in events) / 1e3
    heavy = "; ".join(
        f"{e.key[:40]} x{e.count} {e.self_cpu_time_total / 1e3:.3f} ms"
        for e in events[:top])
    print(f"  host time by op (profiled, {total:.3f} ms in all): {heavy}",
          flush=True)


def dense_logits_kernel_vs_plain(torch, cfg, params, dev, gen):
    """Phase 5b: one dense step's logits with the kernels and with the
    plain attention, each on its own copy of a filled cache of 8 rows and
    1024 positions with ragged lengths, one row at capacity."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    cache = transformer.init_cache(cfg, B, 1024, device=dev)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    cl = torch.randint(1, 1024, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    cl[0] = 1024
    tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    out = []
    for attend in (None, ops.decode_attention_plain):
        c = {n: t.clone() for n, t in cache.items()}
        with torch.no_grad():
            logits, _ = transformer.forward(
                params, cfg, tok, cache_len=cl, cache=c,
                kernels=ops.Kernels(attend=attend))
        out.append(logits[:, -1])
        del c
    return out, cl.tolist()


# ---------------------------------------------------- phase 4: logits -----

# ---------------------------------- phase 5c: Fig. 12's churn and spill --


def fig12_budgets(rng, n: int) -> list[int]:
    """Bimodal budgets (``fig12_serving._budgets``): 2-6 tokens, a quarter
    of the requests 28-32."""
    heavy = rng.random(n) < 0.25
    return [int(rng.integers(28, FIG12_MAX_TOKENS + 1)) if h
            else int(rng.integers(2, 7)) for h in heavy]


def fig12_requests(n: int, vocab: int) -> list[tuple[int, int, int]]:
    """Part A's ``(tag, budget, prompt token)`` requests."""
    import numpy as np
    rng = np.random.default_rng(FIG12_SEED)
    budgets = fig12_budgets(rng, n)
    toks = rng.integers(1, vocab, size=n)
    return [(tag, b, int(t)) for tag, (b, t) in enumerate(zip(budgets, toks))]


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def fig12_drive(serve_on_main, port: int, reqs, sched):
    """Replay the schedule against a server that ``serve_on_main(reply
    port)`` runs on this thread; a sender and a reply collector run on
    helpers. Returns (the server's stats, {tag: latency ms}, {tag:
    generated tokens})."""
    import numpy as np

    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.bind(("127.0.0.1", 0))
    client.settimeout(1.0)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    send_ts, recv_ts, replies = {}, {}, {}

    def send():
        t0 = time.monotonic()
        for (tag, budget, tok), at in zip(reqs, sched):
            d = t0 + at - time.monotonic()
            if d > 0:
                time.sleep(d)
            send_ts[tag] = time.monotonic()
            tx.sendto(np.asarray([budget, tag, tok], np.int32).tobytes(),
                      ("127.0.0.1", port))

    def collect():
        end = time.monotonic() + 120.0
        while len(recv_ts) < len(reqs) and time.monotonic() < end:
            try:
                data, _ = client.recvfrom(4096)
            except socket.timeout:
                continue
            tag, *gen = np.frombuffer(data, np.int32).tolist()
            recv_ts[tag] = time.monotonic()
            replies[tag] = gen

    threads = [threading.Thread(target=f, daemon=True,
                                name=f"fig12-{f.__name__}")
               for f in (collect, send)]
    for t in threads:
        t.start()
    try:
        stats = serve_on_main(client.getsockname()[1])
    finally:
        for t in threads:
            t.join(timeout=150)
        client.close()
        tx.close()
    lat = {t: (recv_ts[t] - send_ts[t]) * 1e3 for t in recv_ts
           if t in send_ts}
    return stats, lat, replies


def fig12_part_a(torch, cfg, params, *, n_requests: int,
                 counters=()) -> dict:
    """Part A: the closed buckets (``serve_model(batch_decode=True,
    per_request_tokens=True)`` over a 40-position dense cache) and the
    continuous engine (``serve_model_continuous`` over the paged pool)
    replay one open-loop schedule; the engine's calibration drain (8 slots,
    6 steps) sets the pace. ``counters`` are zeroed before each server's
    replay and read after it. Returns both servers' numbers, replies and
    launches."""
    import numpy as np

    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.models.registry import get_api
    from repro_torch.serving.engine import make_engine
    from repro_torch.serving.server import GenesysUdpServer, _tile_cache
    from repro_torch.train.steps import make_serve_step

    dev = params["embed"].device
    reqs = fig12_requests(n_requests, cfg.vocab_size)
    budgets = [b for _, b, _ in reqs]
    serve = make_serve_step(cfg)
    cache = get_api(cfg).init_cache(cfg, 1, FIG12_MAX_TOKENS + 8, device=dev)
    # warm every power-of-two bucket a poll of <= 8 can give, feeding each
    # step's cache to the next
    cur = torch.ones((FIG12_SLOTS, 1), dtype=torch.int32, device=dev)
    cl = torch.zeros((FIG12_SLOTS,), dtype=torch.int32, device=dev)
    for kb in (1, 2, 4, FIG12_SLOTS):
        c = _tile_cache(cache, kb)
        for _ in range(2):
            _, c = serve(params, c, cur[:kb], cl[:kb])
    del c

    # the continuous engine first: its warm drain is also the service-rate
    # calibration of the schedule
    g_cont = Genesys(GenesysConfig(n_workers=2))
    g = Genesys(GenesysConfig(n_workers=2))
    try:
        eng = make_engine(cfg, params, n_slots=FIG12_SLOTS,
                          n_blocks=FIG12_ARENA, block_size=FIG12_BLOCK,
                          gsys=g_cont)
        check(eng.admit(np.asarray([3], np.int32), 2), "fig12: warm admit")
        eng.drain()
        for i in range(FIG12_SLOTS):
            check(eng.admit(np.asarray([3 + i], np.int32), 6),
                  "fig12: calibration admit")
        t0 = time.monotonic()
        eng.drain()
        step_s = (time.monotonic() - t0) / 6
        eng.stats = type(eng.stats)()
        eng.pool.stats = type(eng.pool.stats)()
        interval = (sum(budgets) / len(budgets) * step_s
                    / (FIG12_SLOTS * FIG12_OVERSUBSCRIBE))
        burst = 2 * FIG12_SLOTS
        sched = [0.0] * burst + [(i + 1) * interval
                                 for i in range(max(0, n_requests - burst))]

        runs = {}
        srv = GenesysUdpServer(g, port=0, max_batch=FIG12_SLOTS, payload=512,
                               batch_window_s=0.005)
        port = g.table._sockets[srv.fd].getsockname()[1]
        try:
            def closed(cport):
                return srv.serve_model(
                    serve, params, cache, n_batches=10 ** 9,
                    reply_port=cport, max_tokens=FIG12_MAX_TOKENS,
                    n_requests=n_requests, max_idle_polls=100,
                    batch_decode=True, per_request_tokens=True)
            zero_counts(counters)
            runs["closed"] = fig12_drive(closed, port, reqs, sched)
            closed_launches = read_counts(counters)
        finally:
            srv.close()
        srv = GenesysUdpServer(g_cont, port=0, max_batch=FIG12_SLOTS,
                               payload=512, batch_window_s=0.005)
        port = g_cont.table._sockets[srv.fd].getsockname()[1]
        try:
            def continuous(cport):
                return srv.serve_model_continuous(
                    eng, reply_port=cport, n_requests=n_requests,
                    max_tokens=FIG12_MAX_TOKENS)
            zero_counts(counters)
            runs["continuous"] = fig12_drive(continuous, port, reqs, sched)
            cont_launches = read_counts(counters)
        finally:
            srv.close()
        # the arena's working set peaks mid-run (retirement DONTNEEDs
        # every block back, so the final RSS is ~0)
        rss_peak = max((r for _, r in g_cont.pool._trace), default=0)
    finally:
        g.shutdown()
        g_cont.shutdown()
    out = {"n_requests": n_requests, "calibration_step_ms": 1e3 * step_s,
           "interval_ms": 1e3 * interval, "kv_rss_peak_bytes": rss_peak,
           "engine_steps": eng.stats.steps,
           "continuous_occupancy": eng.stats.occupancy(),
           "launches": {"closed": closed_launches,
                        "continuous": cont_launches}}
    for name, (stats, lat, replies) in runs.items():
        out[f"{name}_tokens_per_s"] = stats.tokens_out / stats.wall_s
        out[f"{name}_tokens_out"] = stats.tokens_out
        out[f"{name}_wall_s"] = stats.wall_s
        out[f"{name}_dispatches"] = stats.decode_dispatches
        out[f"{name}_steps_per_dispatch"] = (stats.decode_steps
                                             / max(1, stats.decode_dispatches))
        out[f"{name}_p50_ms"] = _pct(list(lat.values()), 0.50)
        out[f"{name}_p99_ms"] = _pct(list(lat.values()), 0.99)
        out[f"{name}_replies"] = replies
    out["speedup"] = (out["continuous_tokens_per_s"]
                      / max(1e-9, out["closed_tokens_per_s"]))
    out["budgets"] = {tag: b for tag, b, _ in reqs}
    return out


def fig12_part_b_run(eng, vocab: int, n_sharers: int) -> dict:
    """Part B on a built engine of either package (2 slots, 12 blocks of
    4, a table of 10, a spill file): a sharer of a two-block prefix seals
    it, ``n_sharers`` more reuse it, a 40-token request evicts it (PWRITE64
    spill) and one more sharer revives it (PREAD64_FIXED). Returns the
    pool's and engine's counts from the first reuse on, and every
    request's tokens by name."""
    import numpy as np

    bs = eng.block_size
    prefix = np.random.default_rng(7).integers(1, vocab,
                                               size=2 * bs).tolist()
    tokens = {}

    def run(name, prompt, budget):
        check(eng.admit(np.asarray(prompt, np.int32), budget, meta=name),
              f"fig12 part B: {name} not admitted")
        for meta, gen in eng.drain():
            tokens[meta] = gen

    run("seal", prefix + [11], 2)
    eng.stats = type(eng.stats)()
    eng.pool.stats = type(eng.pool.stats)()
    t0 = time.monotonic()
    for i in range(n_sharers):
        run(f"sharer{i}", prefix + [20 + i], 2)
    reuse_s = time.monotonic() - t0
    # 10 blocks wanted, 9 on the free list: the sealed prefix is evicted
    run("evictor", [5], 10 * bs)
    run("revived", prefix + [99], 2)
    st = eng.pool.stats
    return {"prefix_hits": st.prefix_hits,
            "prefill_steps_saved": eng.stats.prefill_steps_saved,
            "spill_writes": st.spill_writes, "fixed_reads": st.fixed_reads,
            "evictions": st.evictions, "sharers_wall_s": reuse_s,
            "prefix": prefix, "tokens": tokens}


def fig12_part_b(torch, cfg, params, *, n_sharers: int = FIG12_SHARERS,
                 counters=()) -> dict:
    """Part B through the port's engine (``counters`` zeroed before and
    read after), then the revived sharer's request on a fresh engine that
    evicted nothing."""
    import numpy as np

    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.serving.engine import make_engine

    def engine(g, spill):
        return make_engine(cfg, params, n_slots=2, n_blocks=12,
                           block_size=FIG12_BLOCK, max_blocks_per_seq=10,
                           gsys=g, spill_path=spill)

    with tempfile.TemporaryDirectory() as tmp:
        g = Genesys(GenesysConfig(n_workers=2))
        try:
            zero_counts(counters)
            out = fig12_part_b_run(engine(g, str(Path(tmp) / "kv.spill")),
                                   cfg.vocab_size, n_sharers)
            out["launches"] = read_counts(counters)
        finally:
            g.shutdown()
        g = Genesys(GenesysConfig(n_workers=2))
        try:
            fresh = engine(g, str(Path(tmp) / "fresh.spill"))
            check(fresh.admit(np.asarray(out["prefix"] + [99], np.int32), 2),
                  "fig12 part B: the fresh engine refused the request")
            out["fresh_tokens"] = fresh.drain()[0][1]
            out["fresh_evictions"] = fresh.pool.stats.evictions
        finally:
            g.shutdown()
    return out


def fig12_launches(fig12: dict, name: str) -> int:
    """Phase 5c's launches of one counter over its three runs."""
    a = fig12["part_a"]["launches"]
    return (a["closed"][name] + a["continuous"][name]
            + fig12["part_b"]["launches"][name])


def fig12_phase(torch, cfg, params) -> dict:
    """Phase 5c: Parts A and B at full width with their checks: every tag
    answered with exactly its budget by both servers; K2 launched once per
    layer and closed-bucket dispatch and K1 once per layer and engine step,
    every launch appending, the append never alone; prefix hits, a spill
    and a revival, the revived sharer's tokens equal a fresh engine's.
    Tokens/s of each server, their ratio (the reference gates it at 1.5x,
    a claim for a future benchmark cell: printed, not gated), latencies,
    steps per dispatch, occupancy and the arena's RSS peak are printed."""
    from repro_torch.kernels import ops

    counters = (ops.paged_decode_attention, ops.decode_attention,
                ops.update_kv_buffer)
    t0 = time.perf_counter()
    a = fig12_part_a(torch, cfg, params, n_requests=FIG12_REQUESTS,
                     counters=counters)
    a_s = time.perf_counter() - t0
    for name in ("closed", "continuous"):
        replies = a.pop(f"{name}_replies")
        for tag, budget in a["budgets"].items():
            got = replies.get(tag)
            check(got is not None, f"fig12 {name}: tag {tag} not answered")
            check(len(got) == budget, f"fig12 {name}: tag {tag} got "
                  f"{len(got)} tokens, budget {budget}")
            check(all(0 <= t < cfg.vocab_size for t in got),
                  f"fig12 {name}: tag {tag} token ids out of range")
    del a["budgets"]
    n = cfg.n_layers
    closed, cont = a["launches"]["closed"], a["launches"]["continuous"]
    for label, got, kernel, per in (
            ("closed", closed, "decode_attention", a["closed_dispatches"]),
            ("continuous", cont, "paged_decode_attention",
             a["engine_steps"])):
        check(got[kernel] == n * per and got[f"{kernel}_fused"] == n * per,
              f"fig12 {label}: {kernel} launched {got[kernel]} times "
              f"({got[f'{kernel}_fused']} appending), expected {n} x {per}")
        check(got["update_kv_buffer"] == 0, f"fig12 {label}: the append "
              f"launched alone {got['update_kv_buffer']} times")
    check(closed["paged_decode_attention"] == 0
          and cont["decode_attention"] == 0,
          "fig12: a server ran the other server's kernel")
    print(f"fig12 part A ({a['n_requests']} requests, {FIG12_SLOTS} slots, "
          f"calibration step {a['calibration_step_ms']:.2f} ms, arrivals "
          f"every {a['interval_ms']:.2f} ms after a burst of "
          f"{2 * FIG12_SLOTS}): every tag answered with its budget by both "
          f"servers; closed tokens/s={a['closed_tokens_per_s']:.1f} "
          f"(p50 {a['closed_p50_ms']:.1f} ms, p99 {a['closed_p99_ms']:.1f} "
          f"ms, {a['closed_steps_per_dispatch']:.2f} steps/dispatch, "
          f"{a['closed_dispatches']} dispatches) continuous tokens/s="
          f"{a['continuous_tokens_per_s']:.1f} (p50 "
          f"{a['continuous_p50_ms']:.1f} ms, p99 "
          f"{a['continuous_p99_ms']:.1f} ms, "
          f"{a['continuous_steps_per_dispatch']:.2f} steps/dispatch, "
          f"occupancy {a['continuous_occupancy']:.2f} of {FIG12_SLOTS}, "
          f"{a['engine_steps']} steps); continuous/closed = "
          f"{a['speedup']:.3f}x (the reference's gate, 1.5x, is not "
          f"applied here); arena RSS peak {a['kv_rss_peak_bytes']} B; "
          f"launches closed {closed} continuous {cont}; {a_s:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    b = fig12_part_b(torch, cfg, params, counters=counters)
    b_s = time.perf_counter() - t0
    revived, fresh = b["tokens"]["revived"], b.pop("fresh_tokens")
    print(f"fig12 part B ({FIG12_SHARERS} sharers of a {2 * FIG12_BLOCK}-"
          f"token prefix): prefix_hits={b['prefix_hits']} "
          f"prefill_steps_saved={b['prefill_steps_saved']} "
          f"spill_writes={b['spill_writes']} fixed_reads={b['fixed_reads']} "
          f"evictions={b['evictions']}; the revived sharer {revived} vs a "
          f"fresh engine {fresh} (evictions {b['fresh_evictions']}); "
          f"launches {b['launches']}; {b_s:.1f} s", flush=True)
    check(b["prefix_hits"] > 0, "fig12 part B: the shared prefix never hit")
    check(b["spill_writes"] >= 1 and b["fixed_reads"] >= 1,
          f"fig12 part B: {b['spill_writes']} spill writes, "
          f"{b['fixed_reads']} PREAD64_FIXED revivals")
    check(revived == fresh and b["fresh_evictions"] == 0,
          f"fig12 part B: the revived sharer decoded {revived}, a fresh "
          f"engine {fresh}")
    pb = b["launches"]
    check(pb["paged_decode_attention"] > 0 and pb["paged_decode_attention"]
          == pb["paged_decode_attention_fused"]
          and pb["update_kv_buffer"] == 0,
          f"fig12 part B: launches {pb}")
    del b["tokens"], b["prefix"]
    return {"part_a": dict(a, wall_s=a_s), "part_b": dict(b, wall_s=b_s)}


def paged_state(torch, cfg, dev, gen, *, n_blocks, max_len):
    """A filled arena and 8 rows of ragged cached lengths on distinct
    random blocks, with one token per row to feed."""
    from repro_torch.models import transformer
    arenas = transformer.init_paged_arena(cfg, n_blocks, BS, device=dev)
    for a in arenas.values():
        a.copy_(torch.randn(a.shape, generator=gen, device=dev))
    cl = torch.randint(1, max_len, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    pages = [int(n) // BS + 1 for n in cl.tolist()]
    width = max(pages)
    order = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = torch.zeros((B, width), dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(pages):
        bt[b, :n] = order[at:at + n].to(torch.int32)
        at += n
    tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    return arenas, bt, cl, tok


def host_ms(torch, fn, reps: int) -> float:
    """Median wall time of ``fn`` ending in a device sync (host clock)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def device_busy_ms(torch, fn, top: int = 0):
    """Sum of the device time of the kernels ``fn`` launches, from
    torch.profiler (CUPTI); None where the profiler records no device
    time on this machine. ``device_busy_ms.ops`` is then the number of
    device operations the call ran. With ``top``, also prints that number
    and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    device_busy_ms.ops = None
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        us = sum(e.self_device_time_total for e in events)
    except (RuntimeError, AttributeError) as e:
        print(f"device busy: not measured ({e})", flush=True)
        return None
    if us > 0:
        device_busy_ms.ops = sum(e.count for e in events
                                 if e.self_device_time_total > 0)
    if top and us > 0:
        heavy = sorted(events, key=lambda e: -e.self_device_time_total)
        print(f"  device ops (kernels, copies, sets): {device_busy_ms.ops}; "
              "device time by kernel: " + "; ".join(
                  f"{e.key[:48]} x{e.count} "
                  f"{e.self_device_time_total / 1e3:.3f} ms"
                  for e in heavy[:top]), flush=True)
    return us / 1e3 if us > 0 else None


def logits_kernel_vs_plain(torch, cfg, params, state):
    """Logits of one paged step with the kernels and with the plain
    attention, each on its own copy of the arenas (the step writes K/V)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    arenas, bt, cl, tok = state
    out = []
    for attend in (None, ops.paged_decode_attention_plain):
        ar = {n: a.clone() for n, a in arenas.items()}
        with torch.no_grad():
            logits, _ = transformer.forward(
                params, cfg, tok, cache_len=cl,
                paged_cache=(ar["k"], ar["v"], bt),
                kernels=ops.Kernels(attend=attend))
        out.append(logits[:, -1])
        del ar
    return out


# ------------------------------------------- phase 6: flash attention --

def fa_reading(got, want, r: float) -> dict:
    """The K3 comparison of one output ([B,S,heads,hd]): the largest
    absolute error, the largest ratio of error to the element's bound
    ``r * (|want| + rms_vec + rms / 16)`` (the rule holds while it is at
    most 1), and the relative Frobenius error."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rms_vec = w.square().mean(dim=-1, keepdim=True).sqrt()
    rms = w.square().mean().sqrt()
    bound = r * (w.abs() + rms_vec + rms / 16)
    return {"max_abs_err": diff.max().item(),
            "worst": (diff / bound).max().item(),
            "frob": (diff.norm() / w.norm()).item()}


def flash_cases_of(torch):
    """Phase 6's cases: (label, B, Sq, Skv, dtype, (H, KV, hd), causal).
    The training shapes (starcoder2-7b's in bf16 and f32, a ragged S =
    1000, zamba2's shared block at hd 80, moonshot's H = KV = 16),
    seamless-m4t-medium's attention as an encoder-decoder would run it:
    non-causal self-attention over its 4096 frames and cross-attention of
    1024 decoder positions over them (hd 64), and the reduced configs'
    heads (H 4 over KV 2 at hd 32; phase 21 trains on them) at S = 4096 and
    1000 in bf16 and f32, and in bf16 at the training example's batch of 8
    rows of 64. zamba2's hd 80 and seamless's encoder (hd 64) run in f32
    too: the f32 kernels serve every head dim. Moonlight's latent attention
    (the benchmark cell's shape: H = KV = 16, a query/key head dim of 192
    and a value head dim of 128, given as the pair) in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.port_configs import MOONLIGHT as ml

    def heads(arch, reduced=False):
        c = get_config(arch).reduced() if reduced else get_config(arch)
        return c.n_heads, c.n_kv_heads, c.hd
    enc = get_config("seamless-m4t-medium")
    bf, f32 = torch.bfloat16, torch.float32
    reduced = heads("internlm2-20b", reduced=True)
    return (
        ("S4096-bfloat16", 1, TRAIN_SEQ, TRAIN_SEQ, bf, (H, KV, HD), True),
        ("S4096-float32", 1, TRAIN_SEQ, TRAIN_SEQ, f32, (H, KV, HD), True),
        ("S1000-tail-bfloat16", 1, 1000, 1000, bf, (H, KV, HD), True),
        ("S4096-hd80-bfloat16", 1, TRAIN_SEQ, TRAIN_SEQ, bf,
         heads("zamba2-2.7b"), True),
        ("S4096-hd80-float32", 1, TRAIN_SEQ, TRAIN_SEQ, f32,
         heads("zamba2-2.7b"), True),
        ("S4096-moonshot-bfloat16", 1, TRAIN_SEQ, TRAIN_SEQ, bf,
         heads("moonshot-v1-16b-a3b"), True),
        ("S4096-mla-192-128-bfloat16", 1, TRAIN_SEQ, TRAIN_SEQ, bf,
         (ml.n_heads, ml.n_kv_heads, (ml.qk_head_dim, ml.v_head_dim)), True),
        ("S4096-encoder-hd64-bfloat16", 1, enc.n_frame_tokens,
         enc.n_frame_tokens, bf, heads("seamless-m4t-medium"), False),
        ("S4096-encoder-hd64-float32", 1, enc.n_frame_tokens,
         enc.n_frame_tokens, f32, heads("seamless-m4t-medium"), False),
        ("Sq1024-Skv4096-cross-hd64-bfloat16", 1, 1024, enc.n_frame_tokens,
         bf, heads("seamless-m4t-medium"), False)) + tuple(
        (f"S{s}-hd32-{str(dt).split('.')[-1]}", 1, s, s, dt, reduced, True)
        for s in (TRAIN_SEQ, 1000) for dt in (bf, f32)) + (
        ("B8-S64-hd32-bfloat16", FA_PATH_BATCH, FA_PATH_SEQ, FA_PATH_SEQ, bf,
         reduced, True),)


def flash_kernel_phase(torch, dev, flush, labels=None):
    """K3a and K3b against their plain versions at the shapes they serve
    (flash_cases_of; only those named in ``labels`` if given). The backward
    kernel and its plain version take the same o and lse (the plain
    forward's), so each comparison sees one kernel; two calls of the
    backward kernel must give the same bits. K3b is timed whole and as its
    launches (delta, dq, dk/dv). In FA_CONTROL_CASES a control holds the
    kernel's outputs, 3% off in the second half of the rows (keys for dk,
    dv), to the same rule: it must fail. In bf16 the training mode too
    (``ops.flash_attention`` with a gradient): K3a also writing its f32
    output, which must round to its bf16 one, and K3b taking delta from an
    f32 o (the plain forward's, on both sides), each held to the same rule
    and timed. Each case's bound is the largest of its bytes, its products
    and its exponentials (one a (query, key) pair, in the forward and in
    the backward, which need p once) at the SFU's rate; the products at
    the bf16 peak, or in f32 at the split-TF32 design's (three tf32
    products a product at the TF32 rate), with the f32 peak's bound beside
    it (``bound_f32_ms``). A case's head dim may be a pair (query/key,
    value): q and k take the first, v, o and do the second."""
    from repro_torch.kernels import flash_attention as fa

    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    cases = {"fwd": [], "bwd": []}
    for label, nb, sq, skv, dt, (nh, nkv, hd), causal in flash_cases_of(
            torch):
        if labels is not None and label not in labels:
            continue
        name = str(dt).split(".")[-1]
        dqk, dv = hd if isinstance(hd, tuple) else (hd, hd)
        q, do = (torch.randn(nb, sq, nh, d, generator=gen,
                             device=dev).to(dt) for d in (dqk, dv))
        k, v = (torch.randn(nb, skv, nkv, d, generator=gen,
                            device=dev).to(dt) for d in (dqk, dv))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        grads = fa.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal=causal)
        again = fa.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal=causal)
        grads_p = fa.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do,
                                               causal=causal)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
        check(bit_equal, f"flash attention [{label}]: two backward calls on "
              f"the same inputs differ")
        del again
        r = FA_REL[name]
        errs, control = {}, {}
        for n, got, want in (("o", o, o_p), ("dq", grads[0], grads_p[0]),
                             ("dk", grads[1], grads_p[1]),
                             ("dv", grads[2], grads_p[2])):
            errs[n] = fa_reading(got, want, r)
            e = errs[n]
            check(e["worst"] <= 1.0 and e["frob"] <= FA_FROB[name],
                  f"flash attention [{label}] {n}: error up to "
                  f"{e['worst']:.3g} x its bound (max abs "
                  f"{e['max_abs_err']:.3g}), relative Frobenius "
                  f"{e['frob']:.3g} (tol {FA_FROB[name]})")
            if label in FA_CONTROL_CASES:
                off = got.clone()
                off[:, off.shape[1] // 2:] *= FA_CONTROL_SCALE
                control[n] = fa_reading(off, want, r)
                check(control[n]["worst"] > 1.0, f"flash attention control: "
                      f"{n} 3% off in half its rows passes the rule")
                del off
        lse_err = (lse - lse_p).abs().max().item()
        check(lse_err <= FA_LSE_ATOL, f"flash attention [{label}] lse error "
              f"{lse_err} > {FA_LSE_ATOL}")
        f32_out = {}
        if name == "bfloat16":      # training's mode
            o32, o32_p = (torch.empty(do.shape, dtype=torch.float32,
                                      device=dev) for _ in range(2))
            o_t, _ = fa.flash_attention_fwd(q, k, v, causal=causal,
                                            out_f32=o32)
            fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                         out_f32=o32_p)
            g32 = fa.flash_attention_bwd(q, k, v, o32_p, lse_p, do,
                                         causal=causal)
            g32_p = fa.flash_attention_bwd_plain(q, k, v, o32_p, lse_p, do,
                                                 causal=causal)
            torch.cuda.synchronize()
            check(torch.equal(o_t, o) and torch.equal(o32.to(dt), o),
                  f"flash attention [{label}]: the f32 output does not "
                  f"round to the bf16 one")
            f32_out["errors"] = {
                n: fa_reading(got, want, r) for n, got, want in (
                    ("o32", o32, o32_p), ("dq", g32[0], g32_p[0]),
                    ("dk", g32[1], g32_p[1]), ("dv", g32[2], g32_p[2]))}
            for n, e in f32_out["errors"].items():
                check(e["worst"] <= 1.0 and e["frob"] <= FA_FROB[name],
                      f"flash attention [{label}] {n} with delta from the "
                      f"f32 o: error up to {e['worst']:.3g} x its bound, "
                      f"relative Frobenius {e['frob']:.3g}")
            del o_t, o32_p, g32, g32_p
        del o_p, lse_p, grads_p, o, grads
        torch.cuda.empty_cache()
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        # (query, key) pairs the attention needs: s(s+1)/2 a head causal
        pairs = nb * nh * (sq * (sq + 1) / 2 if causal else sq * skv)
        esz = q.element_size()
        # q, o and k, v; the backward also do, dq and dk, dv
        io_fwd = nb * ((sq * nh + skv * nkv) * (dqk + dv) * esz + 4 * nh * sq)
        io_bwd = nb * (2 * (sq * nh + skv * nkv) * (dqk + dv) * esz
                       + 4 * nh * sq)
        # exponentials: the function needs p once a pair, forward and
        # backward (the kernels' dq and dk/dv each recompute it: that
        # second pass is the design's cost, not the function's); at the
        # MUFU pipe's rate (SFU_OPS_PER_S)
        sfu = dict.fromkeys(("fwd", "bwd"), pairs / SFU_OPS_PER_S * 1e3)
        tf32x3 = name == "float32"     # the f32 kernels' split TF32
        bounds, bounds_f32 = {}, {}
        # a pair's products: q k and p v forward; the backward's s again,
        # dp = do v, dv = p do, dq = ds k and dk = ds q
        for k_, io, flops in (("fwd", io_fwd, 2.0 * pairs * (dqk + dv)),
                              ("bwd", io_bwd, pairs * (6.0 * dqk + 4 * dv))):
            bounds_f32[k_] = max(bound_ms(io, flops, name),
                                 (sfu[k_], "operations"))
            ops = (3 * flops / TF32_FLOPS if tf32x3
                   else flops / PEAK_FLOPS[name]) * 1e3
            bounds[k_] = max((io / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (ops, "operations"), (sfu[k_], "operations"))
        reps = 10 if name == "bfloat16" else 3
        ms_f, host_f = cuda_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal), reps=reps, flush=flush)
        ms_b, host_b = cuda_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), reps=reps, flush=flush)
        if f32_out:
            f32_out["fwd_ms"], _ = cuda_ms(torch, lambda: (
                fa.flash_attention_fwd(q, k, v, causal=causal,
                                       out_f32=o32)), reps=reps, flush=flush)
            f32_out["bwd_ms"], _ = cuda_ms(torch, lambda: (
                fa.flash_attention_bwd(q, k, v, o32, lse, do,
                                       causal=causal)), reps=reps,
                flush=flush)
            del o32
        # K3b's launches alone, on buffers of one call (delta first: dq
        # and dk/dv read the stats it writes)
        bufs = (tuple(torch.empty_like(x) for x in (q, k, v)),
                *fa.bwd_scratch(q, k))

        def launch(parts):
            fa.bwd_launch(q, k, v, o, lse, do, *bufs, causal=causal,
                          parts=parts)
        split = {part: cuda_ms(torch, lambda: launch(bit), reps=reps,
                               flush=flush)[0]
                 for part, bit in (("delta", 1), ("dq", 2), ("dkv", 4))}
        del bufs
        plain_f, _ = cuda_ms(torch, lambda: fa.flash_attention_fwd_plain(
            q, k, v, causal=causal), reps=3, flush=flush)
        plain_b, _ = cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal), reps=3, flush=flush)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():     # yardstick only, never on the path
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_f, _ = cuda_ms(torch, sdpa, reps=reps, flush=flush)
        lib_fb, _ = cuda_ms(torch, lambda: sdpa().backward(dot), reps=reps,
                            flush=flush)
        del qt, kt, vt
        for kind, ms, host, plain, lib in (
                ("fwd", ms_f, host_f, plain_f, lib_f),
                ("bwd", ms_b, host_b, plain_b, lib_fb - lib_f)):
            bnd, by = bounds[kind]
            outs = ("o",) if kind == "fwd" else ("dq", "dk", "dv")
            case = {"case": label, "batch": nb, "sq": sq, "skv": skv,
                    "causal": causal, "heads": nh, "kv_heads": nkv,
                    "head_dim": hd, "bound_sfu_ms": sfu[kind],
                    "max_abs_err": max(errs[n]["max_abs_err"] for n in outs),
                    "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": bnd, "bound_by": by, "host_call_ms": host,
                    "bound_f32_ms": bounds_f32[kind][0] if tf32x3 else None,
                    "rule_r": r, "frob_tol": FA_FROB[name],
                    "errors": errs, "lse_err": lse_err}
            if control:
                case["control_3pct"] = control
            if kind == "bwd":
                case["library_fwd_bwd_ms"] = lib_fb
                case["launches_ms"] = split
                case["bit_equal_twice"] = bit_equal
            if f32_out:
                case["f32_out_ms"] = f32_out[f"{kind}_ms"]
                case["f32_out_errors"] = f32_out["errors"]
            cases[kind].append(case)
        print(f"kernel flash_attention[{label}] B={nb} H={nh} KV={nkv} "
              f"hd={hd} "
              f"{'causal' if causal else 'full'}: errors (max abs, worst "
              f"ratio to the bound r={r:g}, relative Frobenius tol "
              f"{FA_FROB[name]:g}) "
              + " ".join(f"{n}=({e['max_abs_err']:.3e}, {e['worst']:.3f}, "
                         f"{e['frob']:.3e})" for n, e in errs.items())
              + (" control 3% off: " + " ".join(
                  f"{n}=({e['worst']:.3f}, {e['frob']:.3e})"
                  for n, e in control.items()) if control else "")
              + f" lse={lse_err:.2e} | fwd ms={ms_f:.4f} plain_ms="
              f"{plain_f:.4f} sdpa_ms={lib_f:.4f} bound_ms="
              f"{bounds['fwd'][0]:.4f} ({bounds['fwd'][1]}; SFU "
              f"{sfu['fwd']:.4f}"
              + (f"; f32 peak {bounds_f32['fwd'][0]:.4f}" if tf32x3 else "")
              + f") | bwd ms="
              f"{ms_b:.4f} (delta {split['delta']:.4f}, dq "
              f"{split['dq']:.4f}, dkv {split['dkv']:.4f}) plain_ms="
              f"{plain_b:.4f} sdpa_fwd_bwd_ms={lib_fb:.4f} bound_ms="
              f"{bounds['bwd'][0]:.4f} ({bounds['bwd'][1]}; SFU "
              f"{sfu['bwd']:.4f}"
              + (f"; f32 peak {bounds_f32['bwd'][0]:.4f}" if tf32x3 else "")
              + f") bit-equal "
              f"twice: {bit_equal}"
              + (f" | with the f32 output: fwd ms={f32_out['fwd_ms']:.4f} "
                 f"bwd ms={f32_out['bwd_ms']:.4f}, worst ratios "
                 + " ".join(f"{n}={e['worst']:.3f}"
                            for n, e in f32_out["errors"].items())
                 if f32_out else ""), flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return cases


# -------------------------------------------- phase 7: the training path --

KERNEL_COUNTERS = ("flash_attention_fwd", "flash_attention_bwd",
                   "mamba2_ssd_fwd", "mamba2_ssd_bwd",
                   "rwkv6_wkv_fwd", "rwkv6_wkv_bwd", "gmm_fwd", "gmm_bwd",
                   "paged_decode_attention", "decode_attention",
                   "update_kv_buffer", "moe_dispatch")


def model_flops(cfg, n_params: int, batch: int, seq: int,
                frames: int = 0) -> float:
    """Model FLOPs of one training step: 6 per non-embedding parameter a
    token uses and token (an MoE layer's token uses top_k of its experts:
    ``cfg.active_param_count()``'s basis), causal attention forward and
    backward (6 H hd S^2 per sequence and attention layer), a hybrid's SSD
    scan (three times its forward, 2c(cN + cP + 2NP) per head and chunk)
    and rwkv6's WKV (three times its forward, 2c(2 hd^2 + c hd) per head
    and chunk). The encoder-decoder: :func:`encdec_flops`."""
    from repro_torch.config import Family
    if cfg.family == Family.ENCDEC:
        return encdec_flops(cfg, batch, seq, frames)
    embed = cfg.padded_vocab * cfg.d_model     # a gather, no products
    idle = cfg.param_count() - cfg.active_param_count()   # 0 but for MoE
    out = 6.0 * (n_params - idle - embed) * batch * seq
    out += 6.0 * attention_layers(cfg) * cfg.n_heads * cfg.hd * seq * seq \
        * batch
    if cfg.family == Family.HYBRID:
        c, n, p = min(64, seq), cfg.ssm_state, cfg.ssm_head_dim
        out += 3.0 * 2 * c * (c * n + c * p + 2 * n * p) * cfg.ssm_heads \
            * (seq // c) * batch * cfg.n_layers
    if cfg.family == Family.SSM:
        c, d = min(64, seq), cfg.hd
        out += 3.0 * 2 * c * (2 * d * d + c * d) * cfg.n_heads \
            * (seq // c) * batch * cfg.n_layers
    return out


def encdec_flops(cfg, batch: int, seq: int, frames: int) -> float:
    """Model FLOPs of one encoder-decoder training step over ``frames``
    frames and ``seq`` text tokens a row: 6 per weight a position passes
    and position (the encoder's layers over the frames; the decoder's
    self-attention, cross-attention queries and outputs, MLP and lm_head
    over the text; the cross-attention's K and V projections over the
    frames), and attention forward and backward: 12 H hd S^2 a non-causal
    encoder layer, 6 H hd S^2 a causal decoder layer, 12 H hd S_text
    S_enc a cross-attention."""
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    attn = 2 * D * H * hd + 2 * D * KV * hd
    mlp = (3 if cfg.mlp_kind == "swiglu" else 2) * D * F
    weights = (cfg.n_enc_layers * (attn + mlp) * frames
               + cfg.n_layers * ((attn + 2 * D * H * hd + mlp) * seq
                                 + 2 * D * KV * hd * frames)
               + D * cfg.padded_vocab * seq)
    scores = (2 * cfg.n_enc_layers * frames * frames
              + cfg.n_layers * (seq * seq + 2 * seq * frames))
    return 6.0 * batch * (weights + H * hd * scores)


def ar1_frames(torch, gen, rows: int, length: int, d: int, device,
               std: float = FRAME_STD):
    """Stand-in audio features [rows, length, d] float32 from ``gen``: an
    AR(1) process along time, x_t = a x_{t-1} + sqrt(1 - a^2) e_t with
    a = exp(-1 / FRAME_CORR) and e_t of standard deviation ``std``, so
    that neighbouring frames are alike and far ones are not (as speech
    features are). Summed as a log-depth scan: after the pass of shift k
    each frame holds its last 2k terms."""
    a = math.exp(-1.0 / FRAME_CORR)
    x = torch.randn((rows, length, d), generator=gen, device=device) * std
    x[:, 1:] *= math.sqrt(1 - a * a)
    k = 1
    while k < length:
        x = torch.cat([x[:, :k], x[:, k:] + a ** k * x[:, :-k]], dim=1)
        k *= 2
    return x


class FramesLoader:
    """Smoke scaffolding for the encoder-decoder's training (the reference
    has no frame loader): a ``GenesysDataLoader`` whose every batch also
    carries ``embeds`` [rows, n_frames, D] float32, AR(1) frames
    (:func:`ar1_frames`) from a seed, one seed a batch."""

    def __init__(self, loader, n_frames: int, d: int, seed: int):
        self.loader, self.n_frames, self.d = loader, n_frames, d
        self.seed = seed

    def next_batch(self) -> dict:
        import torch
        batch = self.loader.next_batch()
        gen = torch.Generator()
        gen.manual_seed(self.seed)
        self.seed += 1
        batch["embeds"] = ar1_frames(torch, gen, len(batch["tokens"]),
                                     self.n_frames, self.d, "cpu").numpy()
        return batch

    def close(self) -> None:
        self.loader.close()


def train_path_phase(torch, tcfg, dev, *, expected: dict,
                     seq: int = TRAIN_SEQ, frames: int = 0):
    """Train ``tcfg`` at full width through the port's Trainer,
    GenesysDataLoader and CheckpointManager; resume in a fresh Trainer.
    ``expected`` maps kernel counters to their launches over the run (every
    other counter must stay 0); every step must update every leaf through
    AdamW's kernels, one norm and one update launch. Rows of ``seq``
    tokens; with ``frames``
    (the encoder-decoder), each row also carries that many frames
    (:class:`FramesLoader`). Returns the phase's numbers."""
    import numpy as np

    from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
    from repro_torch.config import TrainConfig
    from repro_torch.core.genesys import Genesys, GenesysConfig
    from repro_torch.data.pipeline import GenesysDataLoader, write_token_shard
    from repro_torch.kernels import adamw as KA
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_api
    from repro_torch.optim import AdamW
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import make_train_step

    check(tcfg.remat == "full" and tcfg.params_dtype == "float32"
          and tcfg.compute_dtype == "bfloat16", f"{tcfg.arch_id}'s training "
          f"config changed")
    init = get_api(tcfg).init
    work = ROOT / "build" / "smoke_train"     # gitignored, removed below
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gsys = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=200,
                                 coalesce_max=8))
    try:
        shard = str(work / "tokens.bin")
        write_token_shard(shard, np.random.default_rng(0).integers(
            0, 500, size=2_000_000).astype(np.uint32))
        free_gb = shutil.disk_usage(work).free / 1e9
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init(tcfg, seed=0, device=dev, master=True)
        n_params = sum(x.numel() for x in flatten(params))
        n_leaves = len(flatten(params))
        inner, opt = make_train_step(tcfg, TrainConfig(
            microbatches=TRAIN_MICRO))
        step_s, gnorms = [], []

        def train_step(*args):      # ends in the loop's float(loss) anyway
            t0 = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            gnorms.append(float(out[2]["grad_norm"]))
            return out
        loader = GenesysDataLoader(gsys, [shard], batch=TRAIN_BATCH,
                                   seq=seq)
        if frames:
            loader = FramesLoader(loader, frames, tcfg.d_model, seed=0)
        cm = CheckpointManager(gsys, str(work / "ckpt"), keep=1)
        counters = [getattr(ops, n) for n in KERNEL_COUNTERS]
        for c in counters:
            c.launches = 0
        KA.adamw_sqnorm.launches = KA.adamw_update.launches = 0
        AdamW.fused_leaves = AdamW.plain_leaves = 0
        tr = Trainer(gsys, train_step, params, opt.init(params), loader,
                     ckpt=cm, ckpt_every=TRAIN_STEPS)
        st = tr.run(TRAIN_STEPS)
        check(st.ckpts == 1 and cm.latest_step() == TRAIN_STEPS,
              f"checkpoints {st.ckpts}, latest {cm.latest_step()}")
        state_bytes = cm.stats["bytes"]
        save_s = cm.stats["save_wall_s"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        saved = [x.detach().cpu() for x in flatten(
            {"params": tr.params, "opt": tr.opt_state})]
        losses = list(st.losses)
        del tr, params
        gc.collect()
        torch.cuda.empty_cache()

        # a fresh trainer over other weights resumes from the checkpoint
        params = init(tcfg, seed=1, device=dev, master=True)
        tr = Trainer(gsys, train_step, params, opt.init(params), loader,
                     ckpt=cm, ckpt_every=TRAIN_STEPS)
        t0 = time.perf_counter()
        check(tr.resume(), "resume found no checkpoint")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(tr.step == TRAIN_STEPS, f"resumed at step {tr.step}")
        live = flatten({"params": tr.params, "opt": tr.opt_state})
        check(len(live) == len(saved), "restored tree differs")
        for i, (a, b) in enumerate(zip(live, saved)):
            check(a.dtype == b.dtype and torch.equal(a.cpu(), b),
                  f"restored leaf {i} differs from the saved state")
        del saved
        st2 = tr.run(RESUME_STEPS)
        losses += st2.losses[-RESUME_STEPS:]
        launches = {f.__name__: f.launches for f in counters}
        adamw = {"sqnorm_launches": KA.adamw_sqnorm.launches,
                 "update_launches": KA.adamw_update.launches,
                 "fused_leaves": AdamW.fused_leaves,
                 "plain_leaves": AdamW.plain_leaves}
        run_steps = TRAIN_STEPS + RESUME_STEPS
        check(adamw == {"sqnorm_launches": run_steps,
                        "update_launches": run_steps,
                        "fused_leaves": run_steps * n_leaves,
                        "plain_leaves": 0},
              f"{tcfg.arch_id} training: AdamW {adamw} over {run_steps} "
              f"steps of {n_leaves} leaves")
        check(all(math.isfinite(x) for x in losses + gnorms),
              f"non-finite loss or grad norm: {losses} {gnorms}")
        check(statistics.mean(losses[-2:]) < losses[0],
              f"loss did not fall: {losses}")
        for name, n in launches.items():
            check(n == expected.get(name, 0), f"{tcfg.arch_id} training: "
                  f"{name} launched {n} times, expected "
                  f"{expected.get(name, 0)}")

        # one more step alone, profiled: device busy time
        batch = {k: torch.from_numpy(x).to(dev)
                 for k, x in loader.next_batch().items()}
        busy_ms = device_busy_ms(torch, lambda: inner(tr.params, tr.opt_state,
                                                      batch), top=12)
        loader.close()
    finally:
        gsys.shutdown()
        shutil.rmtree(work, ignore_errors=True)

    tokens = TRAIN_BATCH * seq
    steady = step_s[1:]      # the first step builds the allocator's pools
    step_ms = 1e3 * statistics.median(steady)
    flops = model_flops(tcfg, n_params, TRAIN_BATCH, seq, frames)
    steps = TRAIN_STEPS + RESUME_STEPS
    out = {
        "arch": tcfg.arch_id, "layers": tcfg.n_layers, "params": n_params,
        "batch": TRAIN_BATCH, "seq": seq, "microbatches": TRAIN_MICRO,
        "steps": steps, "losses": losses, "grad_norms": gnorms,
        "step_ms": [1e3 * x for x in step_s], "median_step_ms": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3), "peak_mem_gb": peak_gb,
        "step_device_busy_ms": busy_ms, "ckpt_bytes": state_bytes,
        "ckpt_save_wall_s": save_s, "restore_s": restore_s,
        "disk_free_gb_before": free_gb, "model_flops_per_step": flops,
        "model_flops_share_of_bf16_peak":
            flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"],
        "launches": launches, "adamw": adamw,
    }
    layers, row = f"{tcfg.n_layers} layers", f"{seq}"
    if frames:
        out.update(frames=frames, enc_layers=tcfg.n_enc_layers,
                   frames_per_s=TRAIN_BATCH * frames / (step_ms / 1e3))
        layers = f"{tcfg.n_enc_layers} + {tcfg.n_layers} layers"
        row = f"({frames} frames + {seq} text)"
    busy = "not measured" if busy_ms is None else f"{busy_ms:.1f}"
    print(f"train path: {tcfg.arch_id} full width, {layers} "
          f"({n_params / 1e9:.3f} B params, f32 master, bf16 compute, remat "
          f"full), {TRAIN_BATCH}x{row} tokens/step in {TRAIN_MICRO} "
          f"microbatches: losses {[round(x, 4) for x in losses]} grad_norms "
          f"{[round(x, 4) for x in gnorms]} step_ms "
          f"{[round(1e3 * x, 1) for x in step_s]} median {step_ms:.1f} "
          f"tokens/s={out['tokens_per_s']:.0f}"
          + (f" frames/s={out['frames_per_s']:.0f}" if frames else "")
          + f" peak_mem={peak_gb:.2f} GB "
          f"device_busy_ms={busy} checkpoint {state_bytes} B saved in "
          f"{save_s:.1f} s (disk free before {free_gb:.1f} GB), restored in "
          f"{restore_s:.1f} s, bit-equal; model flops/step "
          f"{flops:.4g} = {out['model_flops_share_of_bf16_peak']:.3f}"
          f" of the bf16 peak; launches={launches} adamw={adamw}",
          flush=True)
    return out


def step_kernel_vs_plain(torch, cfg, dev, *, layers: int, plain,
                         control, control_label: str, prepare=None,
                         bf16_seeds=(), pin_routing: bool = False,
                         seq: int = TRAIN_SEQ, frames: int = 0,
                         frame_std: float = FRAME_STD):
    """Phase 7b (and 9b, 12b): the training phase's step (2 microbatches of
    1 x 4096 tokens) at ``layers`` layers of full width, from the same
    weights, with the kernels, with the plain versions (``plain``: an
    ``ops.Kernels`` of the step's), and with a control that must
    fail the comparison (``control``: a plain version that drops one tile
    or one chunk's carry). bf16 and f32 compute. ``prepare(params, seed)`` may
    set weights before the runs. In bf16, the kernels are held to the
    plain versions again on each seed of ``bf16_seeds`` (weights, prepared
    weights and tokens all drawn from it). Each gradient is read from the
    step's first moments, which a fresh state leaves at (1 - beta1) *
    min(1, clip / grad_norm) * g. With ``pin_routing`` (phase 17b), the
    bf16 plain and control steps take the kernel step's top-k expert
    choices (:class:`PinnedRouting`): one ulp of difference flips a near-tied
    choice (:func:`routing_flips` counts them), which moves the flipped
    token's gradients by O(1) and is no fault of a kernel; pinned, both
    steps follow one routing and the gradients are compared as phase 7b
    compares them. f32 routes alike without the pin. The encoder-decoder
    (``frames``: AR(1) frames of ``frame_std`` a row beside ``seq`` text
    tokens) runs ``layers`` encoder and ``layers`` decoder layers. The
    kernel step's K3a/K3b launches are counted (``k3_launches``: in f32
    they are the f32 kernels' launches on the smoke's paths)."""
    import numpy as np

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_api
    from repro_torch.train.steps import make_train_step

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        return tree.detach().clone()

    def batch_of(seed):
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 500, size=(TRAIN_BATCH, seq + 1))).to(dev)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        if frames:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            batch["embeds"] = ar1_frames(torch, gen, TRAIN_BATCH, frames,
                                         cfg.d_model, dev, frame_std)
        return batch

    tc = TrainConfig(microbatches=TRAIN_MICRO)
    with_frames = (f" (+ {frames} frames of std {frame_std:g})" if frames
                   else "")
    out = {}
    for compute in ("bfloat16", "float32"):
        scfg = dataclasses.replace(cfg, n_layers=layers,
                                   compute_dtype=compute)
        if frames:
            scfg = dataclasses.replace(scfg, n_enc_layers=layers)

        def weights(seed, prepare_seed):
            base = get_api(scfg).init(scfg, seed=seed, device=dev,
                                      master=True)
            if prepare is not None:
                prepare(base, prepare_seed)
            return base

        def one_step(base, batch, kernels):
            step, opt = make_train_step(scfg, tc, kernels)
            params = clone(base)
            _, state, metrics = step(params, opt.init(params), batch)
            gnorm = float(metrics["grad_norm"])
            scale = (1 - tc.beta1) * min(1.0, tc.grad_clip / max(gnorm,
                                                                 1e-9))
            grads = [m.div_(scale) for m in flatten(state.m)]
            return float(metrics["loss"]), gnorm, grads

        def against_plain(res, ref):
            loss, gnorm, grads = res
            rels = [(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b).clamp_min(1e-30)).item()
                    for a, b in zip(grads, ref[2])]
            rel = max(rels)
            d_loss = abs(loss - ref[0])
            ok = (math.isfinite(loss) and d_loss <= STEP_LOSS_ATOL[compute]
                  and rel <= STEP_GRAD_REL[compute])
            return {"loss": loss, "loss_abs_diff": d_loss, "grad_norm": gnorm,
                    "grad_leaf_max_rel_norm_diff": rel,
                    "grad_leaf_max": names[rels.index(rel)], "pass": ok}

        base, batch = weights(3, 9), batch_of(7)
        names = leaf_paths(base)
        pin = PinnedRouting() if pin_routing and compute == "bfloat16" \
            else None
        k3_wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd)
        before = [c.launches for c in k3_wrappers]
        with pin.record() if pin else contextlib.nullcontext():
            got = one_step(base, batch, ops.KERNELS)
        k3 = {c.__name__: c.launches - n
              for c, n in zip(k3_wrappers, before)}
        with pin.replay() if pin else contextlib.nullcontext():
            ref = one_step(base, batch, plain)
        kern = against_plain(got, ref)
        with pin.replay() if pin else contextlib.nullcontext():
            ctrl = against_plain(one_step(base, batch, control), ref)
        del got
        print(f"train step kernels vs plain ({cfg.arch_id}, {compute} "
              f"compute, {layers} layers full width, {TRAIN_BATCH}x"
              f"{seq}{with_frames} in "
              f"{TRAIN_MICRO} microbatches): loss "
              f"{kern['loss']:.6f} vs {ref[0]:.6f} (|diff| "
              f"{kern['loss_abs_diff']:.3e}, tol {STEP_LOSS_ATOL[compute]}) "
              f"grad leaves max relative norm diff "
              f"{kern['grad_leaf_max_rel_norm_diff']:.3e} at "
              f"{kern['grad_leaf_max']} (tol "
              f"{STEP_GRAD_REL[compute]}) grad_norm {kern['grad_norm']:.6f} "
              f"vs {ref[1]:.6f}; control ({control_label}): |loss diff| "
              f"{ctrl['loss_abs_diff']:.3e} grad leaves "
              f"{ctrl['grad_leaf_max_rel_norm_diff']:.3e} at "
              f"{ctrl['grad_leaf_max']}"
              + ("; routing pinned to the kernel step's" if pin else ""),
              flush=True)
        check(kern["pass"], f"{compute} step, kernels vs plain: {kern}")
        check(not ctrl["pass"], f"{compute} step: the control "
              f"({control_label}) passes the comparison: {ctrl}")
        out[compute] = {"kernels": kern, "control": ctrl,
                        "loss_plain": ref[0], "grad_norm_plain": ref[1],
                        "k3_launches": k3}
        del base, ref
        gc.collect()
        torch.cuda.empty_cache()
        if compute != "bfloat16" or not bf16_seeds:
            continue
        out[compute]["kernels_other_seeds"] = []
        for seed in bf16_seeds:
            base, batch = weights(seed, seed), batch_of(seed)
            ref = one_step(base, batch, plain)
            kern = dict(against_plain(one_step(base, batch, ops.KERNELS),
                                      ref),
                        seed=seed)
            print(f"train step kernels vs plain ({cfg.arch_id}, {compute}, "
                  f"seed {seed}): |loss diff| {kern['loss_abs_diff']:.3e} "
                  f"grad leaves max relative norm diff "
                  f"{kern['grad_leaf_max_rel_norm_diff']:.3e} at "
                  f"{kern['grad_leaf_max']} (tol {STEP_GRAD_REL[compute]})",
                  flush=True)
            check(kern["pass"], f"{compute} step, kernels vs plain, seed "
                  f"{seed}: {kern}")
            out[compute]["kernels_other_seeds"].append(kern)
            del base, ref
            gc.collect()
            torch.cuda.empty_cache()
    return out


class PinnedRouting:
    """Phase 17b's bf16 routing pin: :meth:`record` is a routing tap that
    keeps every route's top-k choices in call order (forward, and remat's
    forward again in the backward); under :meth:`replay`, a run that makes
    the same calls in the same order takes those choices back and gates
    them with its own probabilities, so its gates, capacity and gradients
    follow the recorded routing."""

    def __init__(self):
        self.picks = []

    def record(self):
        from repro_torch.models import moe

        def choose(idx):
            self.picks.append(idx)
            return idx
        return moe.RoutingTap(choose=choose)

    @contextlib.contextmanager
    def replay(self):
        from repro_torch.models import moe
        picks = iter(self.picks)
        with moe.RoutingTap(choose=lambda idx: next(picks)):
            yield
        check(next(picks, None) is None, "a pinned step routed fewer times "
              "than the step it replays")


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """The path of every leaf of a parameter tree, in ``flatten`` order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                             f"{prefix}/{k}")]
    return [prefix]


def dropped_tile(q, k, v, *, causal, q_offset=0):
    """Plain attention with keys CONTROL_KEYS of K and V zeroed: phase 7b's
    control, a kernel that loads one tile wrong."""
    from repro_torch.models import layers as L
    keep = k.new_ones((k.shape[1], 1, 1))
    keep[CONTROL_KEYS[0]:CONTROL_KEYS[1]] = 0
    return L.flash_attention_xla(q, k * keep, v * keep, causal=causal,
                                 q_offset=q_offset)


# ---------------------------------------------- phase 8: the SSD scan ---

def mamba2_decay_init(torch, heads: int, gen, dev):
    """(A_log, dt_bias) [heads] as Mamba2's reference initialisation draws
    them: A uniform in [1, 16], dt log-uniform in [1e-3, 1e-1] and dt_bias
    its inverse softplus. The repo's init (A = -1, dt_bias = 0, so dt near
    0.7) decays a chunk's carried state by about e^-45 over 64 positions;
    these carry it across many chunks, as a trained model does, so that a
    comparison can see the carry."""
    a = 1 + 15 * torch.rand(heads, generator=gen, device=dev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(heads, generator=gen,
                                               device=dev))
    return torch.log(a), dt + torch.log(-torch.expm1(-dt))


def ssd_inputs(torch, zcfg, dev, gen, batch: int, length: int, dtype):
    """zamba2's scan inputs: x and dy [B,L,H,P] in ``dtype``, dt =
    softplus(N(0,1) + dt_bias) and A = -exp(A_log) from
    :func:`mamba2_decay_init`, Bm and Cm [B,L,N] N(0,1)."""
    F = torch.nn.functional
    H, P, N = zcfg.ssm_heads, zcfg.ssm_head_dim, zcfg.ssm_state
    a_log, dt_bias = mamba2_decay_init(torch, H, gen, dev)
    x, dy = (torch.randn(batch, length, H, P, generator=gen, device=dev)
             .to(dtype) for _ in range(2))
    dt = F.softplus(torch.randn(batch, length, H, generator=gen, device=dev)
                    + dt_bias)
    Bm, Cm = (torch.randn(batch, length, N, generator=gen, device=dev)
              for _ in range(2))
    return (x, dt, -torch.exp(a_log), Bm, Cm), dy


def halves(fn, ins, dy=None):
    """``fn`` (a scan's forward, or with ``dy`` its backward) run on the
    two halves of the sequence apart: the carried state (or, backwards,
    its cotangent) across the middle chunk boundary is dropped. Inputs and
    outputs of three or more dims ([B, L, ...]) are cut and joined along
    L, the others (A, u; dA, du) taken whole and summed. Forward: the
    output; backward: the gradients."""
    import torch
    half = ins[0].shape[1] // 2
    parts = []
    for sl in (slice(None, half), slice(half, None)):
        cut = [t[:, sl].contiguous() if t.dim() >= 3 else t for t in ins]
        parts.append(fn(*cut) if dy is None
                     else fn(*cut, dy[:, sl].contiguous()))
    if dy is None:
        return torch.cat([parts[0][0], parts[1][0]], dim=1)
    return tuple(torch.cat([a, b], dim=1) if a.dim() >= 3 else a + b
                 for a, b in zip(*parts))


def carry_dropped(plain):
    """``plain`` (a scan's plain version) with the carry across the middle
    chunk boundary dropped: the control of phases 9b, 10, 12b and 13, a
    kernel that loses one chunk's state. The final state, which no
    caller reads, is None."""
    return lambda *ins: (halves(plain, ins), None)


# the scans' kernels that launch_split_ms keeps, by a part of their names
SPLIT_KERNELS = ("ssd", "wkv", "carry", "sum_mid")


def launch_split_ms(torch, fn, flush, total_ms: float, reps: int = 10,
                    tries: int = 3, within: float = 0.05):
    """Device ms of each kernel ``fn`` launches, by kernel name (with its
    template arguments; torch.profiler, CUPTI), per call, and their sum.
    One profiled call counts each name's launches a call; then ``reps``
    calls, each after the L2 flush, give each name's mean per launch (its
    device time over the launches the profiler recorded) times its
    launches a call. Only the scans' kernels (names holding one of
    SPLIT_KERNELS) are kept, not the flush's. In the smoke's run the
    profiler has lost some launches and read others short (PERF.md §6),
    so a split is kept only where every launch was recorded and the split
    sums to within ``within`` of ``total_ms``, the call's time by CUDA
    events: of up to ``tries`` profiles, the first that does. Otherwise
    ``ms`` is None and ``sums`` holds what each profile summed to. None
    where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    def profiled(calls):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if not any(n in e.key for n in SPLIT_KERNELS):
                continue
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ").strip()
            t, n = out.get(name, (0.0, 0))
            out[name] = (t + e.self_device_time_total / 1e3, n + e.count)
        return out

    sums = []
    try:
        once = profiled(1)
        for _ in range(tries):
            runs = profiled(reps)
            if not runs or not all(t > 0 for t, _ in runs.values()):
                return None
            per_call = {k: max(once.get(k, (0, 0))[1], round(n / reps), 1)
                        for k, (_, n) in runs.items()}
            split = {k: t / n * per_call[k] for k, (t, n) in runs.items()}
            sums.append(sum(split.values()))
            if all(n == reps * per_call[k] for k, (_, n) in runs.items()) \
                    and abs(sums[-1] - total_ms) <= within * total_ms:
                return {"ms": split, "sum_ms": sums[-1], "sums": sums}
    except (RuntimeError, AttributeError) as e:
        print(f"launch split: not measured ({e})", flush=True)
        return None
    return {"ms": None, "sum_ms": None, "sums": sums}


def split_text(split) -> str:
    """launch_split_ms's reading for a log line."""
    if not split:
        return ""
    if split["ms"] is None:
        return " launches not kept (profiles summed to " + ", ".join(
            f"{v:.4f}" for v in split["sums"]) + ")"
    return f" launches (sum {split['sum_ms']:.4f}) " + " ".join(
        f"{n}={v:.4f}" for n, v in split["ms"].items())


def ssd_work(B: int, L: int, H: int, P: int, N: int, f32_x: bool):
    """Multiply-add flops of K4 and K4b at their least: as f32 products
    (the plain version's) and as the split-TF32 design's tf32 products. A
    chunk of c positions forms its scores C B^T (2 c^2 N) once for all
    heads (ngroups = 1). Each head then runs, forward: the intra-chunk
    output (2 c^2 P, on x), the carried state's output (2 c N P) and the
    chunk's state (2 c N P, on x); backward: D = dy u^T (2 c^2 P, on dy
    and x), the intra-chunk dx (2 c^2 P, on dy), dCm's and dBm's intra
    terms (2 c^2 N each), and five [N, P] products: the state and its
    cotangent W (on x and dy), dCm's carried term (on dy), dx's (on the
    state cotangent) and dBm's (on x). A split-TF32 product costs one tf32
    product for each pair of parts but lo x lo: 3 for two f32 operands, 2
    where one is a bf16 x or dy (exact in tf32), 1 for dy x^T in bf16."""
    c = min(64, L)
    chunks = B * (L // c)
    xp = 2 if f32_x else 1                 # tf32 parts of x and dy

    def parts(a, b):
        return a * b - (a == b == 2)
    cc, cn = 2 * c * c, 2 * c * N * P
    fwd = [(cc * N / H, 2, 2), (cc * P, xp, 2), (cn, 2, 2), (cn, xp, 2)]
    bwd = [(cc * N / H, 2, 2), (cc * P, xp, xp), (cc * P, xp, 2),
           (cc * N, 2, 2), (cc * N, 2, 2), (cn, xp, 2), (cn, xp, 2),
           (cn, xp, 2), (cn, 2, 2), (cn, xp, 2)]
    f32, tf32 = {}, {}
    for k, terms in (("fwd", fwd), ("bwd", bwd)):
        f32[k] = chunks * H * sum(f for f, _, _ in terms)
        tf32[k] = chunks * H * sum(f * parts(a, b) for f, a, b in terms)
    return f32, tf32


def ssd_kernel_phase(torch, zcfg, dev, flush):
    """K4 and K4b against their plain versions at zamba2's shape (B = 1, L
    = 4096, H 80, P 64, N 64) with x in bf16 and in f32, at L = 48 and L =
    40 (one chunk of 48, and of 40: no multiple of 16), and at B = 4, L =
    256 (the launcher's batches put several rows in one call). Each output
    element is held to SSD_REL of its own size and its vector's; at L =
    4096 in bf16 the kernels' outputs with the carry across the middle
    chunk boundary dropped must fail that rule. Two K4b calls on the same
    inputs must give the same bits. At L = 4096 each launch is also timed
    apart (launch_split_ms)."""
    from repro_torch.kernels import mamba2_scan as ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    cases = {"fwd": [], "bwd": []}
    names = ("y", "s_final", "dx", "ddt", "dA", "dBm", "dCm")
    for label, batch, length, dt in (
            ("L4096-bfloat16", 1, TRAIN_SEQ, torch.bfloat16),
            ("L4096-float32", 1, TRAIN_SEQ, torch.float32),
            ("L48-one-chunk-bfloat16", 1, 48, torch.bfloat16),
            ("B4-L256-bfloat16", 4, 256, torch.bfloat16),
            ("L40-one-chunk-bfloat16", 1, 40, torch.bfloat16)):
        ins, dy = ssd_inputs(torch, zcfg, dev, gen, batch, length, dt)
        got = ms.mamba2_ssd_fwd(*ins) + ms.mamba2_ssd_bwd(*ins, dy)
        again = ms.mamba2_ssd_bwd(*ins, dy)
        want = ms.ssd_chunked_plain(*ins) + ms.ssd_backward_plain(*ins, dy)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(got[2:], again))
        check(bit_equal, f"SSD scan [{label}]: two backward calls on the "
              f"same inputs differ")
        del again
        errs, control = {}, {}
        for n, g, w in zip(names, got, want):
            errs[n] = fa_reading(g, w, SSD_REL[str(g.dtype).split(".")[-1]])
            check(errs[n]["worst"] <= 1.0, f"SSD scan [{label}] {n}: error "
                  f"up to {errs[n]['worst']:.3g} x its bound (max abs "
                  f"{errs[n]['max_abs_err']:.3g})")
        if label == "L4096-bfloat16":
            off = (halves(ms.mamba2_ssd_fwd, ins),) + (None,) \
                + halves(ms.mamba2_ssd_bwd, ins, dy)
            for n, g, w in zip(names, off, want):
                if g is not None:
                    control[n] = fa_reading(
                        g, w, SSD_REL[str(g.dtype).split(".")[-1]])
            for n in SSD_CONTROL_FAILS:
                check(control[n]["worst"] > 1.0, f"SSD scan control: {n} "
                      f"with the middle carry dropped passes the rule")
            del off
        del got, want
        torch.cuda.empty_cache()
        x = ins[0]
        B, L, H, P = x.shape
        N = ins[3].shape[-1]
        c = min(64, L)
        esz = x.element_size()
        io_f = 2 * x.numel() * esz + 4 * (B * L * H + H + 2 * B * L * N
                                          + B * H * N * P)
        io_b = 4 * x.numel() * esz + 4 * (2 * B * L * H + 2 * H
                                          + 4 * B * L * N)
        flops, tf32_flops = ssd_work(B, L, H, P, N, x.dtype == torch.float32)
        io = {"fwd": io_f, "bwd": io_b}
        # the split-TF32 design's bound (tf32 products at the TF32
        # tensor-core rate) and, beside it, the f32 CUDA-core one
        bounds = {k: max((io[k] / HBM_BYTES_PER_S * 1e3, "bytes"),
                         (tf32_flops[k] / TF32_FLOPS * 1e3, "operations"))
                  for k in flops}
        bounds_f32 = {k: bound_ms(io[k], flops[k], "float32") for k in flops}
        ms_f, host_f = cuda_ms(torch, lambda: ms.mamba2_ssd_fwd(*ins),
                               reps=10, flush=flush)
        ms_b, host_b = cuda_ms(torch, lambda: ms.mamba2_ssd_bwd(*ins, dy),
                               reps=10, flush=flush)
        plain_f, _ = cuda_ms(torch, lambda: ms.ssd_chunked_plain(*ins),
                             reps=3, flush=flush)
        plain_b, _ = cuda_ms(torch, lambda: ms.ssd_backward_plain(*ins, dy),
                             reps=3, flush=flush)
        split = {}
        if length == TRAIN_SEQ:
            split = {"fwd": launch_split_ms(
                         torch, lambda: ms.mamba2_ssd_fwd(*ins), flush,
                         ms_f),
                     "bwd": launch_split_ms(
                         torch, lambda: ms.mamba2_ssd_bwd(*ins, dy), flush,
                         ms_b)}
        for kind, t, host, plain, outs in (
                ("fwd", ms_f, host_f, plain_f, ("y", "s_final")),
                ("bwd", ms_b, host_b, plain_b,
                 ("dx", "ddt", "dA", "dBm", "dCm"))):
            bnd, by = bounds[kind]
            case = {"case": label, "max_abs_err": max(
                        errs[n]["max_abs_err"] for n in outs),
                    "ms": t, "plain_ms": plain, "library_ms": None,
                    "bound_ms": bnd, "bound_by": by,
                    "bound_f32_ms": bounds_f32[kind][0],
                    "bound_f32_by": bounds_f32[kind][1],
                    "host_call_ms": host,
                    "errors": {n: errs[n] for n in outs}}
            if split.get(kind):
                case["launches_ms"] = split[kind]["ms"]
                case["launches_sum_ms"] = split[kind]["sum_ms"]
                case["launches_profiles_summed"] = split[kind]["sums"]
            if kind == "bwd":
                case["bit_equal_twice"] = bit_equal
            if control:
                case["control_middle_carry_dropped"] = {
                    n: control[n] for n in outs if n in control}
            cases[kind].append(case)
        print(f"kernel mamba2_ssd[{label}]: errors (max abs, worst ratio to "
              f"the bound, relative Frobenius) " + " ".join(
                  f"{n}=({e['max_abs_err']:.3e}, {e['worst']:.3f}, "
                  f"{e['frob']:.3e})" for n, e in errs.items())
              + (" control (middle carry dropped): " + " ".join(
                  f"{n}=({e['worst']:.3f}, {e['frob']:.3e})"
                  for n, e in control.items()) if control else "")
              + "".join(
                  f" | {k} ms={t:.4f} plain_ms={p:.4f} bound_ms="
                  f"{bounds[k][0]:.4f} ({bounds[k][1]}, split TF32) "
                  f"{bounds_f32[k][0]:.4f} ({bounds_f32[k][1]}, f32)"
                  + split_text(split.get(k))
                  for k, t, p in (("fwd", ms_f, plain_f),
                                  ("bwd", ms_b, plain_b)))
              + f" bit-equal twice: {bit_equal}", flush=True)
        del ins, dy, x
        torch.cuda.empty_cache()
    return cases


def set_mamba2_decay(torch, params, seed: int) -> None:
    """Every mamba layer's A_log and dt_bias drawn as Mamba2 initialises
    them (:func:`mamba2_decay_init`), in place."""
    m = params["blocks"]["mamba"]
    gen = torch.Generator(device=m["A_log"].device)
    gen.manual_seed(seed)
    for i in range(m["A_log"].shape[0]):
        a_log, dt_bias = mamba2_decay_init(torch, m["A_log"].shape[1], gen,
                                           m["A_log"].device)
        m["A_log"][i].copy_(a_log)
        m["dt_bias"][i].copy_(dt_bias)


# --------------------------------- phases 10 and 13: recurrent serving ---

def recurrent_serve_phase(torch, cfg, dev, *, prefill_launches: dict,
                          control, prepare=None) -> dict:
    """A recurrent family (zamba2-2.7b, rwkv6-3b) served at full width in
    bf16 by the three dense servers (phase 5's requests), back-to-back
    eager requests against each alone, and, in f32, ``make_prefill_step``
    over 256 tokens against the same tokens fed one at a time through
    ``make_serve_step``; ``prefill_launches`` are the prefill's kernel
    launches (every other counter stays 0), ``control`` the prefill
    step's ``ops.Kernels`` with a scan that drops the carry into chunk 2,
    which must fail, and ``prepare(params)`` sets the f32 weights' decay so
    that the carry reaches across chunks."""
    import numpy as np

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_api
    from repro_torch.serving.server import _greedy_decode
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    api = get_api(cfg)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.arch_id} serving: full width, {cfg.n_layers} layers and "
          f"{attention_layers(cfg)} attention-layer applications, bf16 "
          f"weights from seed 0 in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    out = {"dense_path": dense_path_phase(torch, cfg, params)}

    # back-to-back eager requests on one template cache, each against
    # itself alone on a fresh cache
    serve = make_serve_step(cfg)
    cl = torch.zeros((1,), dtype=torch.int32, device=dev)
    reqs = [(np.asarray([7, 300, 41], np.int32), 9),
            (np.asarray([12], np.int32), 4)]
    alone = [_greedy_decode(serve, params,
                            api.init_cache(cfg, 1, DENSE_LEN, device=dev),
                            cl, p, n) for p, n in reqs]
    shared = api.init_cache(cfg, 1, DENSE_LEN, device=dev)
    together = [_greedy_decode(serve, params, shared, cl, p, n)
                for p, n in reqs]
    written = sum(t.abs().sum().item() for t in flatten(shared))
    print(f"{cfg.arch_id} serving: back-to-back eager requests {together}, "
          f"alone {alone}; the template cache's |sum| {written:.3g} after "
          f"them", flush=True)
    check(together == alone, "a back-to-back eager request read an earlier "
          "request's recurrent state")
    check(written == 0, "an eager request wrote the template cache")
    out["back_to_back_isolated"] = True
    del params, shared
    gc.collect()
    torch.cuda.empty_cache()

    # decode against prefill, f32 at full width and depth
    fcfg = dataclasses.replace(cfg, params_dtype="float32",
                               compute_dtype="float32",
                               kv_cache_dtype="float32")
    fparams = api.init(fcfg, seed=2, device=dev)
    if prepare is not None:
        prepare(fparams)
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        1, fcfg.vocab_size, size=(1, PREFILL_LEN))).to(dev)
    counters = [getattr(ops, n) for n in KERNEL_COUNTERS]
    for c in counters:
        c.launches = 0
    logits, _ = make_prefill_step(fcfg)(fparams, {"tokens": toks})
    launches = {f.__name__: f.launches for f in counters}
    for name, n in launches.items():
        check(n == prefill_launches.get(name, 0), f"prefill: {name} launched "
              f"{n} times, expected {prefill_launches.get(name, 0)}")
    ctrl, _ = make_prefill_step(fcfg, control)(fparams, {"tokens": toks})
    cache = api.init_cache(fcfg, 1, PREFILL_LEN, device=dev)
    step = make_serve_step(fcfg)
    decoded = []
    t0 = time.perf_counter()
    for i in range(PREFILL_LEN):
        nxt, cache = step(fparams, cache, toks[:, i:i + 1],
                          torch.full((1,), i, dtype=torch.int32, device=dev))
        decoded.append(nxt)
    decoded = torch.cat(decoded)
    decode_s = time.perf_counter() - t0
    top2 = logits[0].topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > MARGIN_F32
    same = logits[0].argmax(-1) == decoded
    same_ctrl = ctrl[0].argmax(-1) == decoded
    max_diff_ctrl = (ctrl - logits).abs().max().item()
    print(f"decode vs prefill ({fcfg.arch_id} f32, {PREFILL_LEN} tokens, "
          f"{PREFILL_LEN // 64} chunks): greedy tokens equal at "
          f"{int(same.sum())}/{PREFILL_LEN} positions, at "
          f"{int(same[decided].sum())}/{int(decided.sum())} whose top-2 "
          f"margin exceeds {MARGIN_F32}; control (carry into chunk 2 "
          f"dropped): equal at {int(same_ctrl[decided].sum())}/"
          f"{int(decided.sum())}, logits moved up to {max_diff_ctrl:.3g}; "
          f"{PREFILL_LEN} decode steps in {decode_s:.1f} s; prefill "
          f"launches {launches}", flush=True)
    check(bool(same[decided].all()), "decode and prefill disagree on a "
          "greedy token whose top-2 margin exceeds the limit")
    check(not bool(same_ctrl[decided].all()), "the decode-vs-prefill "
          "control (a dropped carry) passes the comparison")
    out["decode_vs_prefill"] = {
        "tokens": PREFILL_LEN, "equal": int(same.sum()),
        "decided": int(decided.sum()),
        "equal_decided": int(same[decided].sum()),
        "control_equal_decided": int(same_ctrl[decided].sum()),
        "control_max_logit_diff": max_diff_ctrl, "decode_s": decode_s,
        "prefill_launches": launches}
    del fparams, cache, logits, ctrl
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- phase 11: the WKV ------

def rwkv6_decay_init(torch, n_layers: int, d: int, dev):
    """[n_layers, d] decay_base and bonus as RWKV-6 initialises its
    ``time_decay`` and ``time_faaaa`` (RWKV-LM, v6), for channel n and
    layer ratio i / (n_layers - 1): decay -6 + 5 (n / (d - 1))^(0.7 + 1.3
    ratio), spread over [-6, -1], so that w = exp(-exp(decay)) lies in
    [0.69, 0.9975] and a state carries across many chunks; bonus ratio (1
    - n / (d - 1)) + ((n + 1) % 3 - 1) / 10. The repo's init (both 0: w =
    1/e) decays a chunk's state by e^-64 before the next, where no
    comparison can see the carry."""
    ratio = (torch.arange(n_layers, device=dev, dtype=torch.float32)[:, None]
             / max(n_layers - 1, 1))
    idx = torch.arange(d, device=dev)
    n = (idx / (d - 1)).float()[None, :]
    decay = -6 + 5 * n ** (0.7 + 1.3 * ratio)
    bonus = ratio * (1 - n) + ((idx + 1) % 3 - 1).float()[None, :] * 0.1
    return decay, bonus


def set_rwkv6_init(torch, params) -> None:
    """Every block's decay_base and bonus as RWKV-6 initialises them
    (:func:`rwkv6_decay_init`), in place."""
    t = params["blocks"]["tmix"]
    decay, bonus = rwkv6_decay_init(torch, *t["decay_base"].shape,
                                    t["decay_base"].device)
    t["decay_base"].copy_(decay)
    t["bonus"].copy_(bonus)


def wkv_inputs(torch, rcfg, dev, gen, batch: int, length: int, dtype,
               near_clip: bool = False):
    """rwkv6's WKV inputs: r, k, v and do [B,L,H,hd] N(0,1) in ``dtype``;
    u [H,hd] RWKV-6's bonus at a middle layer; w = exp(-exp(x)) with x
    uniform in [-6, -1] (RWKV-6's decay init: w in [0.69, 0.9975]), or,
    near the clip, w log-uniform in [1e-6, 0.2]."""
    H, hd = rcfg.n_heads, rcfg.hd
    r, k, v, do = (torch.randn(batch, length, H, hd, generator=gen,
                               device=dev).to(dtype) for _ in range(4))
    x = torch.rand(batch, length, H, hd, generator=gen, device=dev)
    if near_clip:
        lo, hi = math.log(1e-6), math.log(0.2)
        w = torch.exp(lo + (hi - lo) * x)
    else:
        w = torch.exp(-torch.exp(-6 + 5 * x))
    _, bonus = rwkv6_decay_init(torch, 3, H * hd, dev)
    return (r, k, v, w, bonus[1].reshape(H, hd).contiguous()), do


def wkv_work(B: int, L: int, H: int, hd: int, f32_in: bool):
    """The work of K5 and K5b in their design (csrc/rwkv6_scan.cu), per
    call: (f32 flops, split-TF32 tf32 flops, exponentials and logarithms),
    each a dict over "fwd" and "bwd". A chunk of c rows is cut into blocks
    of 16 (the last may be shorter); the nb (nb - 1) / 2 pairs of a T-block
    above an S-block are products of factors formed once a chunk, the nb
    diagonal blocks sums on the CUDA cores with one exponential per (t, s <
    t, channel). Per (head, chunk), forward: the chunk's state (k, v: 2 c
    D^2), the pairs' scores (2 16^2 D each), their product with v (2 16
    (a + 1) 16 D for T-block a) and the carried state's term (2 c D^2);
    backward: the state and its cotangent W (2 c D^2 each), dA's diagonal
    blocks (once a team, both teams) and pairs (do v^T), dr's state term
    (do S^T), each pair's dA k~ product, dk's and dv's state terms (v G^T,
    k~ G), each pair's A^T, dv's A^T do over the T-blocks at and above each
    S-block, each pair's dA^T and dA^T r~. A split-TF32 product costs one
    tf32 product for each pair of parts but lo x lo: 3 for two f32
    operands, 2 where one is a bf16 r, k, v or do (exact in tf32), 1 for
    two. The f32 flops are the plain version's least (PR 15's count: 2c(2D^2
    + cD) forward and 2c(5D^2 + 5cD/2) backward). Exponentials and
    logarithms: the log of each w once (the state kernel forms cs), the
    decays, each factor of the design (the state kernels' k and r factors,
    block_factors' r and k factors and per-channel vectors, the backward's
    per-element rescalings of dr and dk), the diagonal blocks' pairs."""
    c = min(64, L)
    units = B * H * (L // c)
    D = hd
    xp = 2 if f32_in else 1
    rows = [min(16, c - 16 * a) for a in range((c + 15) // 16)]
    nb = len(rows)

    def parts(a, b):
        return a * b - (a == b == 2)
    cd2 = 2 * c * D * D
    pair_blk = sum(2 * ra * rows[b] * D for a, ra in enumerate(rows)
                   for b in range(a))                # T-block a, S-block b
    upto = sum(2 * ra * 16 * (a + 1) * D for a, ra in enumerate(rows))
    from_s = sum(2 * rows[b] * (c - 16 * b) * D for b in range(nb))
    diag_blk = sum(2 * r * r * D for r in rows)
    fwd = [(cd2, 2, xp), (pair_blk, 2, 2), (upto, 2, xp), (cd2, 2, 2)]
    bwd = [(cd2, 2, xp), (cd2, 2, xp), (2 * diag_blk, xp, xp), (cd2, xp, 2),
           (cd2, xp, 2), (cd2, 2, 2), (pair_blk, xp, xp), (pair_blk, 2, 2),
           (pair_blk, 2, 2), (from_s, 2, xp), (pair_blk, xp, xp),
           (pair_blk, 2, 2)]
    diag = sum(r * (r - 1) // 2 for r in rows) * D
    pairs = nb * (nb - 1) // 2
    cd = c * D
    # forward: cs (the state kernel's, which the out kernel reads), the
    # state's k factor, the decays, the diagonal blocks, the r and k
    # factors, f_ab and g_a; backward: cs, the state's k and r factors, the
    # decays, the diagonal blocks, the r and k factors, f_ab, g_a and h_b,
    # dr's and dk's rescalings, exp(cs_last) for (G o S)
    sfu = {"fwd": cd + cd + D + diag + 2 * cd + (pairs + nb) * D,
           "bwd": cd + 2 * cd + D + diag + 2 * cd
           + (pairs + 2 * nb) * D + 2 * cd + D}
    f32 = {"fwd": units * 2 * c * (2 * D * D + c * D),
           "bwd": units * 2 * c * (5 * D * D + 2.5 * c * D)}
    tf32 = {k: units * sum(f * parts(a, b) for f, a, b in terms)
            for k, terms in (("fwd", fwd), ("bwd", bwd))}
    return f32, tf32, {k: units * v for k, v in sfu.items()}


def wkv_kernel_phase(torch, rcfg, dev, flush):
    """K5 and K5b against their plain versions at rwkv6-3b's shape (B = 1,
    L = 4096, H 40, hd 64) with r, k, v in bf16 and in f32, at L = 48 and
    L = 40 (one chunk of 48, and of 40: no multiple of 16), at B = 4, L =
    256, and with w near the clip (both sides must stay finite). Each
    output element is held to WKV_REL of its own size and its vector's (dw
    near the clip as WKV_CLIP_REL says); at L = 4096 in bf16 the kernels'
    outputs with the carry across the middle chunk boundary dropped must
    fail that rule. Two K5b calls on the same inputs must give the same
    bits. Each case prints three bounds (split-TF32 products at the TF32
    rate, exponentials and logarithms at the card's SFU rate, bytes at the
    memory's) and takes the largest; at L = 4096 each launch is also timed
    apart (launch_split_ms)."""
    from repro_torch.kernels import rwkv6_scan as rs

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    cases = {"fwd": [], "bwd": []}
    names = ("o", "s_final", "dr", "dk", "dv", "dw", "du")
    for label, batch, length, dt, near_clip in (
            ("L4096-bfloat16", 1, TRAIN_SEQ, torch.bfloat16, False),
            ("L4096-float32", 1, TRAIN_SEQ, torch.float32, False),
            ("L48-one-chunk-bfloat16", 1, 48, torch.bfloat16, False),
            ("B4-L256-bfloat16", 4, 256, torch.bfloat16, False),
            ("L4096-near-clip-bfloat16", 1, TRAIN_SEQ, torch.bfloat16,
             True),
            ("L40-one-chunk-bfloat16", 1, 40, torch.bfloat16, False)):
        ins, do = wkv_inputs(torch, rcfg, dev, gen, batch, length, dt,
                             near_clip)
        got = rs.rwkv6_wkv_fwd(*ins) + rs.rwkv6_wkv_bwd(*ins, do)
        again = rs.rwkv6_wkv_bwd(*ins, do)
        want = rs.wkv6_chunked_plain(*ins) + rs.wkv6_backward_plain(*ins,
                                                                    do)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(got[2:], again))
        check(bit_equal, f"WKV [{label}]: two backward calls on the same "
              f"inputs differ")
        del again
        errs, control = {}, {}
        for n, g, w in zip(names, got, want):
            check(bool(torch.isfinite(g).all()) and
                  bool(torch.isfinite(w).all()), f"WKV [{label}] {n}: "
                  f"non-finite values (kernel {bool(torch.isfinite(g).all())}"
                  f" finite, plain {bool(torch.isfinite(w).all())})")
            if n == "dw" and near_clip:
                errs[n] = log_w_reading(g, w, ins[3])
            else:
                errs[n] = fa_reading(g, w,
                                     WKV_REL[str(g.dtype).split(".")[-1]])
            check(errs[n]["worst"] <= 1.0, f"WKV [{label}] {n}: error up to "
                  f"{errs[n]['worst']:.3g} x its bound (max abs "
                  f"{errs[n]['max_abs_err']:.3g})")
        if label == "L4096-bfloat16":
            off = (halves(rs.rwkv6_wkv_fwd, ins),) + (None,) \
                + halves(rs.rwkv6_wkv_bwd, ins, do)
            for n, g, w in zip(names, off, want):
                if g is not None:
                    control[n] = fa_reading(
                        g, w, WKV_REL[str(g.dtype).split(".")[-1]])
            for n in WKV_CONTROL_FAILS:
                check(control[n]["worst"] > 1.0, f"WKV control: {n} with "
                      f"the middle carry dropped passes the rule")
            del off
        del got, want
        torch.cuda.empty_cache()
        r = ins[0]
        B, L, H, hd = r.shape
        esz = r.element_size()
        io = {"fwd": r.numel() * (4 * esz + 4) + 4 * (H * hd
                                                      + B * H * hd * hd),
              "bwd": r.numel() * (7 * esz + 8) + 4 * 2 * H * hd}
        flops, tf32_flops, sfu = wkv_work(B, L, H, hd,
                                          r.dtype == torch.float32)
        # three bounds, the largest taken: split-TF32 products at the TF32
        # rate, exponentials and logarithms at the SFU's, bytes at the
        # memory's; beside them the f32 CUDA-core one (PR 15's)
        three = {k: {"tf32": tf32_flops[k] / TF32_FLOPS * 1e3,
                     "sfu": sfu[k] / SFU_OPS_PER_S * 1e3,
                     "bytes": io[k] / HBM_BYTES_PER_S * 1e3} for k in io}
        bounds = {k: max((v["bytes"], "bytes"), (v["tf32"], "operations"),
                         (v["sfu"], "operations"))
                  for k, v in three.items()}
        bounds_f32 = {k: bound_ms(io[k], flops[k], "float32") for k in io}
        ms_f, host_f = cuda_ms(torch, lambda: rs.rwkv6_wkv_fwd(*ins),
                               reps=10, flush=flush)
        ms_b, host_b = cuda_ms(torch, lambda: rs.rwkv6_wkv_bwd(*ins, do),
                               reps=10, flush=flush)
        plain_f, _ = cuda_ms(torch, lambda: rs.wkv6_chunked_plain(*ins),
                             reps=3, flush=flush)
        plain_b, _ = cuda_ms(torch, lambda: rs.wkv6_backward_plain(*ins, do),
                             reps=3, flush=flush)
        split = {}
        if length == TRAIN_SEQ:
            split = {"fwd": launch_split_ms(
                         torch, lambda: rs.rwkv6_wkv_fwd(*ins), flush, ms_f),
                     "bwd": launch_split_ms(
                         torch, lambda: rs.rwkv6_wkv_bwd(*ins, do), flush,
                         ms_b)}
        for kind, t, host, plain, outs in (
                ("fwd", ms_f, host_f, plain_f, ("o", "s_final")),
                ("bwd", ms_b, host_b, plain_b, ("dr", "dk", "dv", "dw",
                                                "du"))):
            bnd, by = bounds[kind]
            case = {"case": label, "max_abs_err": max(
                        errs[n]["max_abs_err"] for n in outs),
                    "ms": t, "plain_ms": plain, "library_ms": None,
                    "bound_ms": bnd, "bound_by": by,
                    "bound_tf32_ms": three[kind]["tf32"],
                    "bound_sfu_ms": three[kind]["sfu"],
                    "bound_bytes_ms": three[kind]["bytes"],
                    "bound_f32_ms": bounds_f32[kind][0],
                    "bound_f32_by": bounds_f32[kind][1],
                    "host_call_ms": host,
                    "errors": {n: errs[n] for n in outs}}
            if split.get(kind):
                case["launches_ms"] = split[kind]["ms"]
                case["launches_sum_ms"] = split[kind]["sum_ms"]
                case["launches_profiles_summed"] = split[kind]["sums"]
            if kind == "bwd":
                case["bit_equal_twice"] = bit_equal
            if control:
                case["control_middle_carry_dropped"] = {
                    n: control[n] for n in outs if n in control}
            cases[kind].append(case)
        print(f"kernel rwkv6_wkv[{label}]: errors (max abs, worst ratio to "
              f"the bound, relative Frobenius) " + " ".join(
                  f"{n}=({e['max_abs_err']:.3e}, {e['worst']:.3f}, "
                  f"{e['frob']:.3e})" for n, e in errs.items())
              + (" control (middle carry dropped): " + " ".join(
                  f"{n}=({e['worst']:.3f}, {e['frob']:.3e})"
                  for n, e in control.items()) if control else "")
              + "".join(
                  f" | {k} ms={t:.4f} plain_ms={p:.4f} bound_ms="
                  f"{bounds[k][0]:.4f} (split TF32 {three[k]['tf32']:.4f}, "
                  f"SFU {three[k]['sfu']:.4f}, bytes {three[k]['bytes']:.4f};"
                  f" f32 {bounds_f32[k][0]:.4f})" + split_text(split.get(k))
                  for k, t, p in (("fwd", ms_f, plain_f),
                                  ("bwd", ms_b, plain_b)))
              + f" bit-equal twice: {bit_equal}", flush=True)
        del ins, do, r
        torch.cuda.empty_cache()
    return cases


def log_w_reading(got, want, w) -> dict:
    """The near-clip comparison of dw (WKV_CLIP_REL): w * dw against its
    plain version, each element to WKV_CLIP_REL of the largest |w * dw|;
    ``max_abs_err`` is that of dw itself."""
    g, ref = got * w, want * w
    diff = (g - ref).abs()
    return {"max_abs_err": (got - want).abs().max().item(),
            "worst": (diff.max() / (WKV_CLIP_REL * ref.abs().max())).item(),
            "frob": (diff.norm() / ref.norm()).item(),
            "rule": "w * dw to 2**-13 of its largest"}


# ----------------------------------------- phase 14: the grouped matmul --

def gmm_inputs(torch, dev, gen, E, G, K, N, dtype):
    """x [E G, K], w [E, K, N] (std K^-1/2), dy [E G, N] and a tile table
    of one tile of G rows per expert, the experts in a random order."""
    x = torch.randn(E * G, K, generator=gen, device=dev).to(dtype)
    w = (torch.randn(E, K, N, generator=gen, device=dev)
         * K ** -0.5).to(dtype)
    dy = torch.randn(E * G, N, generator=gen, device=dev).to(dtype)
    te = torch.randperm(E, generator=gen, device=dev).to(torch.int32)
    return x, w, dy, te


def shifted(tile_expert, n_experts: int):
    """The controls' tile table: tile 1's expert id moved to the next
    expert."""
    bad = tile_expert.clone()
    bad[1] = (bad[1] + 1) % n_experts
    return bad


def shifted_gmm(x, w, tile_expert, tile_m):
    """Phase 17b's control: the plain grouped matmul over the shifted
    tile table."""
    from repro_torch.kernels.moe_gmm import gmm_plain
    return gmm_plain(x, w, shifted(tile_expert, w.shape[0]), tile_m)


def gmm_case(torch, mg, flush, label, x, w, dy, te, tm, *, reps):
    """One phase-14 case: K6 and K6b (dx, dw) against their plain versions
    by phase 6's rule, a control (tile 1's expert id shifted) that must
    fail it, K6b twice to the same bits; times of the kernels (K6b whole
    and as its dx and dw launches), the plain versions, ``torch.bmm`` over
    the same tiles (each tile's weight gathered beforehand) and the bound.
    A tile whose expert id lies outside [0, E) must come out zero from K6
    and from dx and add nothing to dw; the plain reference takes such a
    tile as zero rows of expert 0. An expert without tiles must get a zero
    dw. Returns the fwd and bwd entries of the kernels line."""
    E, K, N = w.shape
    name = str(x.dtype).split(".")[-1]
    r = FA_REL[name]
    nt = te.shape[0]
    bad = (te < 0) | (te >= E)
    rows_bad = bad.repeat_interleave(tm)
    te_ref = torch.where(bad, torch.zeros_like(te), te)
    x_ref, dy_ref = x.clone(), dy.clone()
    x_ref[rows_bad] = 0
    dy_ref[rows_bad] = 0
    got = {"out": mg.gmm_fwd(x, w, te, tm)}
    got["dx"], got["dw"] = mg.gmm_bwd(x, w, te, tm, dy)
    again = mg.gmm_bwd(x, w, te, tm, dy)
    want = {"out": mg.gmm_plain(x_ref, w, te_ref, tm)}
    want["dx"], want["dw"] = mg.gmm_backward_plain(x_ref, w, te_ref, tm,
                                                   dy_ref)
    bad_te = shifted(te, E)
    ctl = {"out": mg.gmm_fwd(x, w, bad_te, tm)}
    ctl["dx"], ctl["dw"] = mg.gmm_bwd(x, w, bad_te, tm, dy)
    torch.cuda.synchronize()
    errs = {n: fa_reading(got[n], want[n], r) for n in got}
    control = {n: fa_reading(ctl[n], want[n], r) for n in ctl}
    for n in got:
        check(errs[n]["worst"] <= 1.0, f"gmm [{label}] {n}: error up to "
              f"{errs[n]['worst']:.3g} x its bound (max abs "
              f"{errs[n]['max_abs_err']:.3g})")
        if name == "float32":
            check(errs[n]["frob"] <= GMM_F32_FROB, f"gmm [{label}] {n}: "
                  f"relative Frobenius error {errs[n]['frob']:.3g}")
        check(control[n]["worst"] > 1.0, f"gmm control [{label}]: {n} "
              f"with tile 1's expert shifted passes")
    same_bits = all(torch.equal(a, b)
                    for a, b in zip(again, (got["dx"], got["dw"])))
    check(same_bits, f"gmm [{label}]: two K6b calls differ")
    used = sorted(set(te_ref[~bad].tolist()))
    empty = [e for e in range(E) if e not in used]
    zeros = {"out_of_range_tiles": int(bad.sum()), "empty_experts": empty}
    if bad.any():
        check(bool((got["out"][rows_bad] == 0).all())
              and bool((got["dx"][rows_bad] == 0).all()),
              f"gmm [{label}]: a tile whose expert id is out of range is "
              f"not zero")
    if empty:
        check(bool((got["dw"][empty] == 0).all()),
              f"gmm [{label}]: an expert without tiles has a nonzero dw")
    del got, want, ctl, again
    torch.cuda.empty_cache()

    # the bound: what this table needs (no work for an out-of-range tile;
    # the weights of the experts it uses read once, dw written whole). In
    # f32 the design's: a tile of at most 16 rows (the forward and dx)
    # multiplies in f32 on the CUDA cores, larger tiles and dw in split TF32
    # (three tf32 products a product, at the TF32 rate); the f32 peak's
    # beside it
    esz = x.element_size()
    T, Tv = nt * tm, int((~bad).sum()) * tm
    flops = 2.0 * Tv * K * N
    w_used = len(used) * K * N
    nbytes = {"fwd": (T * K + w_used + T * N) * esz,
              "dx": (T * N + w_used + T * K) * esz,
              "dw": (T * K + T * N + E * K * N) * esz,
              "bwd": (2 * T * K + T * N + w_used + E * K * N) * esz}
    split = name == "float32"
    ops_s = {"fwd": (3 * flops / TF32_FLOPS if split and tm > 16
                     else flops / PEAK_FLOPS[name]),
             "dw": 3 * flops / TF32_FLOPS if split
             else flops / PEAK_FLOPS[name]}
    ops_s["dx"] = ops_s["fwd"]
    ops_s["bwd"] = ops_s["dx"] + ops_s["dw"]
    bounds = {k: max((nbytes[k] / HBM_BYTES_PER_S * 1e3, "bytes"),
                     (ops_s[k] * 1e3, "operations")) for k in nbytes}
    bounds_f32 = {k: bound_ms(nbytes[k], flops * (2 if k == "bwd" else 1),
                              "float32") if split else (None, None)
                  for k in nbytes}
    xg, dyg = x.view(nt, tm, K), dy.view(nt, tm, N)
    wg = w[te_ref.long()]

    def bmm_dx():       # yardsticks only, never on the path
        return torch.bmm(dyg, wg.transpose(1, 2))

    def bmm_dw():
        return torch.bmm(xg.transpose(1, 2), dyg)
    timed = {
        "fwd": (lambda: mg.gmm_fwd(x, w, te, tm), reps),
        "dx": (lambda: mg._launch_fwd(dy, w, te, tm, True, "dx"), reps),
        "dw": (lambda: mg._launch_dw(x, dy, te, tm, E), reps),
        "bwd": (lambda: mg.gmm_bwd(x, w, te, tm, dy), reps),
        "plain_fwd": (lambda: mg.gmm_plain(x_ref, w, te_ref, tm), 3),
        "plain_bwd": (lambda: mg.gmm_backward_plain(x_ref, w, te_ref, tm,
                                                    dy_ref), 3),
        "bmm_fwd": (lambda: torch.bmm(xg, wg), reps),
        "bmm_dx": (bmm_dx, reps),
        "bmm_dw": (bmm_dw, reps),
        "bmm_bwd": (lambda: (bmm_dx(), bmm_dw()), reps)}
    ms = {}
    for key, (fn, n) in timed.items():
        ms[key], host = cuda_ms(torch, fn, reps=n, flush=flush)
        if key in ("fwd", "bwd"):
            ms[f"host_{key}"] = host
    del x_ref, dy_ref, wg
    torch.cuda.empty_cache()
    print(f"kernel gmm[{label}]: errors (max abs, worst ratio to the bound "
          f"r={r:g}) " + " ".join(f"{n}=({e['max_abs_err']:.3e}, "
                                  f"{e['worst']:.3f})"
                                  for n, e in errs.items())
          + " control (tile 1 shifted): " + " ".join(
              f"{n}={e['worst']:.3g}" for n, e in control.items())
          + f"; K6b bit-equal twice; zeros {zeros} | "
          + " | ".join(f"{k} ms={ms[k]:.4f} bmm_ms={ms['bmm_' + k]:.4f} "
                       f"bound_ms={bounds[k][0]:.4f} ({bounds[k][1]})"
                       + (f" bound_f32_ms={bounds_f32[k][0]:.4f}" if split
                          else "")
                       for k in ("fwd", "dx", "dw", "bwd"))
          + f" | plain fwd_ms={ms['plain_fwd']:.4f} bwd_ms="
          f"{ms['plain_bwd']:.4f}", flush=True)
    case = f"{label}-E{E}x{tm}-K{K}-N{N}-{name}"
    entries = {}
    for kind, outs in (("fwd", ("out",)), ("bwd", ("dx", "dw"))):
        entries[kind] = {
            "case": case,
            "max_abs_err": max(errs[n]["max_abs_err"] for n in outs),
            "ms": ms[kind], "plain_ms": ms[f"plain_{kind}"],
            "library_ms": ms[f"bmm_{kind}"], "bound_ms": bounds[kind][0],
            "bound_by": bounds[kind][1],
            "bound_f32_ms": bounds_f32[kind][0],
            "host_call_ms": ms[f"host_{kind}"],
            "rule_r": r, "errors": {n: errs[n] for n in outs},
            "control_tile_shifted": {n: control[n] for n in outs},
            "zeros": zeros}
    entries["bwd"].update(bit_equal_twice=same_bits, parts={
        p: {"ms": ms[p], "library_ms": ms[f"bmm_{p}"],
            "bound_ms": bounds[p][0], "bound_by": bounds[p][1],
            "bound_f32_ms": bounds_f32[p][0]}
        for p in ("dx", "dw")})
    return entries


def gmm_kernel_phase(torch, mcfg, dev, flush):
    """K6 (forward) and K6b (dx and dw) against their plain versions at
    the MoE model's expert shapes (E groups, d_model -> d_ff, the
    up-projections): the training step's 512 rows a group and the decode
    step's 4, in bf16 and f32; the down-projection (d_ff -> d_model) at
    512 rows in bf16 and f32; and a table of 200-row tiles (no multiple of the
    kernels' 128-row tiles, so boxes run past each tile's end) over 8
    experts with one tile's id out of range and one expert without tiles,
    in bf16 and f32. Each case by :func:`gmm_case`. Then ``ops.moe_gmm_apply``
    (sort, pad, tile ids on the device) through K6 and, by autograd, K6b
    against the same through the plain versions at ``test_kernels.py``'s
    ragged shapes: random experts with one left empty, and every token on
    one expert."""
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    E, D, F = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
    cases = {"fwd": [], "bwd": []}
    plan = [("decode", 4, D, F, torch.bfloat16),
            ("decode", 4, D, F, torch.float32),
            ("train", 512, D, F, torch.bfloat16),
            ("train", 512, D, F, torch.float32),
            ("train-wo", 512, F, D, torch.bfloat16),
            ("train-wo", 512, F, D, torch.float32)]
    for label, G, K, N, dtype in plan:
        x, w, dy, te = gmm_inputs(torch, dev, gen, E, G, K, N, dtype)
        reps = 10 if dtype == torch.bfloat16 else 3
        entries = gmm_case(torch, mg, flush, label, x, w, dy, te, G,
                           reps=reps)
        for kind in cases:
            cases[kind].append(entries[kind])
        del x, w, dy, te
        torch.cuda.empty_cache()
    # 9 table tiles of 200 rows over 8 experts: expert 3 twice, tile 2's id
    # out of range, expert 4 without tiles; bf16 and f32
    Ep, tm = 8, 200
    for dtype in (torch.bfloat16, torch.float32):
        te = torch.tensor([3, 0, Ep + 1, 5, 3, 7, 1, 2, 6],
                          dtype=torch.int32, device=dev)
        x = torch.randn(9 * tm, D, generator=gen, device=dev).to(dtype)
        w = (torch.randn(Ep, D, F, generator=gen, device=dev)
             * D ** -0.5).to(dtype)
        dy = torch.randn(9 * tm, F, generator=gen, device=dev).to(dtype)
        entries = gmm_case(torch, mg, flush, "partial", x, w, dy, te, tm,
                           reps=10 if dtype == torch.bfloat16 else 3)
        for kind in cases:
            cases[kind].append(entries[kind])
        del x, w, dy, te
        torch.cuda.empty_cache()

    ragged = []
    for T, Dr, Fr, Er, skew in ((512, 128, 256, 8, False),
                                (256, 256, 128, 4, False),
                                (256, 64, 64, 8, True)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            r = FA_REL[name]
            x = torch.randn(T, Dr, generator=gen, device=dev).to(dtype)
            w = (0.05 * torch.randn(Er, Dr, Fr, generator=gen,
                                    device=dev)).to(dtype)
            dy = torch.randn(T, Fr, generator=gen, device=dev).to(dtype)
            if skew:
                ids = torch.full((T,), 3, dtype=torch.int32, device=dev)
            else:
                ids = torch.randint(0, Er, (T,), generator=gen, device=dev,
                                    dtype=torch.int32)
                ids[ids == 1] = 2           # expert 1 gets no token
            outs = {}
            for tag, fn in (("kernel", None), ("plain", mg.gmm_plain)):
                xr, wr = (t.clone().requires_grad_(True) for t in (x, w))
                o = ops.moe_gmm_apply(xr, wr, ids, n_experts=Er, gmm_fn=fn)
                o.backward(dy)
                outs[tag] = {"out": o.detach(), "dx": xr.grad,
                             "dw": wr.grad}
            torch.cuda.synchronize()
            errs = {n: fa_reading(outs["kernel"][n], outs["plain"][n], r)
                    for n in ("out", "dx", "dw")}
            per_token = torch.einsum("td,tdf->tf", x.float(),
                                     w.float()[ids.long()])
            tok_err = (outs["kernel"]["out"].float() - per_token).abs().max()
            label = (f"apply-T{T}-D{Dr}-F{Fr}-E{Er}"
                     f"{'-skewed' if skew else ''}-{name}")
            print(f"kernel gmm[{label}]: errors (max abs, worst) "
                  + " ".join(f"{n}=({e['max_abs_err']:.3e}, "
                             f"{e['worst']:.3f})" for n, e in errs.items())
                  + f"; against the per-token product {tok_err.item():.3e}",
                  flush=True)
            for n, e in errs.items():
                check(e["worst"] <= 1.0, f"gmm [{label}] {n}: error up to "
                      f"{e['worst']:.3g} x its bound")
            ragged.append({"case": label, "errors": errs,
                           "per_token_max_abs_err": tok_err.item()})
    cases["ragged"] = ragged
    return cases


# ------------------------------------------- phase 22: AdamW's kernels ----

def adamw_worst(torch, got, want, kind: str, step=None) -> float:
    """The largest |got - want| over its tolerance (ADAMW_NORM_RTOL's
    note), in slices of 2^26 elements (a leaf is up to 5.8 GB). For p,
    ``step(i, j)`` is lr |m_hat| / (sqrt(v_hat) + eps) over elements [i,
    j) by the eager route's moments: the step's part of the tolerance is
    4e-5 of it, and of lr where the step is smaller."""
    g, w = got.reshape(-1), want.reshape(-1)
    big = w.abs().max()
    worst = torch.zeros((), device=w.device)
    for i in range(0, w.numel(), 1 << 26):
        j = min(i + (1 << 26), w.numel())
        a, b = g[i:j], w[i:j]
        tol = {"p": lambda: 2.0 ** -21 * b.abs() + 4e-5 * step(i, j),
               "m": lambda: 2e-5 * big, "v": lambda: 2e-5 * b.abs()}[kind]()
        worst = torch.maximum(worst, ((a - b).abs() / tol).max())
    return worst.item()


def adamw_kernel_phase(torch, dev, flush) -> list:
    """Phase 22: AdamW's kernels against the eager route at the cells'
    leaf shapes, then timed (the module docstring). Returns a case a
    cell."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as K
    from repro_torch.models.registry import get_api
    from repro_torch.optim.adamw import AdamW, OptState, leaves

    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    cases = []
    held = torch.cuda.memory_allocated()
    for arch, layers, mb in ADAMW_CELLS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        shapes = [t.shape for t in leaves(get_api(cfg).init(
            cfg, device="meta", master=True))]
        n = sum(math.prod(s) for s in shapes)
        opt = AdamW(lr=3e-4, microbatches=mb)

        def draw(scale, square=False):
            out = {}
            for i, s in enumerate(shapes):
                t = torch.randn(s, generator=gen, device=dev)
                out[f"{i:03d}"] = (t.square_().mul_(scale) if square
                                   else t.mul_(scale))
            return out
        ps, gs = draw(1.0), draw(1e-3 * mb)
        ms, vs = draw(1e-3), draw(1e-6, square=True)
        count = torch.full((), 10, dtype=torch.int32, device=dev)
        twin = [{k: t.clone() for k, t in x.items()} for x in (ps, ms, vs)]
        twin_count = count.clone()
        norm = K.adamw_sqnorm(leaves(gs), mb)
        check(torch.equal(norm, K.adamw_sqnorm(leaves(gs), mb)),
              f"adamw [{arch}]: two norms of the same gradients differ")
        before = K.adamw_update.launches
        opt.update(gs, OptState(ms, vs, count), ps)
        check(K.adamw_update.launches == before + 1,
              f"adamw [{arch}]: the update took the eager route")
        # (the returned tree and state name the twin: keep the norm alone)
        eager_norm = opt.update_plain(
            gs, OptState(twin[1], twin[2], twin_count), twin[0])[2]
        torch.cuda.synchronize()
        norm_err = abs(norm.item() - eager_norm.item()) / eager_norm.item()
        c1, c2 = (1 - b ** twin_count.item() for b in (opt.beta1,
                                                        opt.beta2))

        def steps_of(m, v):
            m, v = m.reshape(-1), v.reshape(-1)
            return lambda i, j: opt.lr * torch.clamp(
                (m[i:j] / c1).abs() / ((v[i:j] / c2).sqrt() + opt.eps),
                min=1.0)
        worst = {kind: max(
            adamw_worst(torch, a, b, kind, steps_of(m, v))
            for a, b, m, v in zip(leaves(got), leaves(want),
                                  leaves(twin[1]), leaves(twin[2])))
            for kind, got, want in (("p", ps, twin[0]), ("m", ms, twin[1]),
                                    ("v", vs, twin[2]))}
        check(count.item() == twin_count.item() == 11,
              f"adamw [{arch}]: count {count.item()}")
        check(norm_err <= ADAMW_NORM_RTOL, f"adamw [{arch}]: the norm "
              f"{norm.item()} against the eager {eager_norm.item()}")
        check(max(worst.values()) <= 1.0,
              f"adamw [{arch}]: error up to {worst} x its bound")
        del twin, twin_count
        torch.cuda.empty_cache()

        state = OptState(ms, vs, count)
        lp, lg, lm, lv = (leaves(x) for x in (ps, gs, ms, vs))
        steps = [torch.zeros((), device=dev) for _ in lp]

        def library():
            # clip_grad_norm_(foreach=True)'s calls, on the gradients
            norms = torch._foreach_norm(lg)
            total = torch.linalg.vector_norm(torch.stack(norms))
            coef = torch.clamp(opt.grad_clip / (total + 1e-6), max=1.0)
            torch._foreach_mul_(lg, coef)
            library_update()

        def library_update():
            torch._fused_adamw_(lp, lg, lm, lv, [], steps, lr=opt.lr,
                                beta1=opt.beta1, beta2=opt.beta2,
                                weight_decay=opt.weight_decay, eps=opt.eps,
                                amsgrad=False, maximize=False)

        def update_alone():
            K.adamw_update(lp, lg, lm, lv, count, norm, lr=opt.lr,
                           beta1=opt.beta1, beta2=opt.beta2, eps=opt.eps,
                           weight_decay=opt.weight_decay,
                           grad_clip=opt.grad_clip, divisor=mb)
        timed = {name: cuda_ms(torch, fn, reps=5, flush=flush)[0]
                 for name, fn in (
                     ("ms", lambda: opt.update(gs, state, ps)),
                     ("sqnorm_ms", lambda: K.adamw_sqnorm(lg, mb)),
                     ("update_ms", update_alone),
                     ("plain_ms", lambda: opt.update_plain(gs, state, ps)),
                     ("library_ms", library),
                     ("library_update_ms", library_update))}
        case = {"case": arch, "leaves": len(shapes), "parameters": n,
                "microbatches": mb, "norm_rel_err": norm_err,
                "worst": worst, **timed,
                "bound_ms": 32 * n / HBM_BYTES_PER_S * 1e3,
                "sqnorm_bound_ms": 4 * n / HBM_BYTES_PER_S * 1e3,
                "update_bound_ms": 28 * n / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes"}
        print(f"kernel adamw[{arch}]: {len(shapes)} leaves, {n} parameters,"
              f" norm rel err {norm_err:.2e}, worst "
              + " ".join(f"{k}={v:.3f}" for k, v in worst.items())
              + f"; ms {case['ms']:.3f} (norm {case['sqnorm_ms']:.3f}, "
              f"update {case['update_ms']:.3f}) bound "
              f"{case['bound_ms']:.3f} (norm {case['sqnorm_bound_ms']:.3f}, "
              f"update {case['update_bound_ms']:.3f}); plain "
              f"{case['plain_ms']:.3f}; library {case['library_ms']:.3f} "
              f"(update alone {case['library_update_ms']:.3f})", flush=True)
        cases.append(case)
        del ps, gs, ms, vs, lp, lg, lm, lv, state, steps, norm
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() <= held + (1 << 20),
              f"adamw [{arch}]: {torch.cuda.memory_allocated() - held} "
              f"bytes still held after the case")
    return cases


# --------------------------------------- phases 15-17: the MoE family ----

def moe_main_path_phase(torch, mcfg, dev):
    """Phase 15: the MoE model at full width served through the paged
    engine as phase 3 serves starcoder2 (its requests, 8 slots), over an
    arena of MOE_N_BLOCKS blocks beside the weights; the capacity's drops
    counted on the device and read once, at the end; then one decode step
    alone against the bytes bound of the weights it reads (all but the
    embedding table, of which it gathers 8 rows). Returns (the weights,
    the phase's numbers)."""
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    params = transformer.init(mcfg, seed=0, device=dev)
    torch.cuda.synchronize()
    weights_bytes = sum(t.numel() * t.element_size()
                        for t in flatten(params))
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    print(f"main path: {mcfg.arch_id} full width, {mcfg.n_layers} layers, "
          f"{mcfg.n_experts} experts top-{mcfg.top_k}, bf16 weights from "
          f"seed 0 in {time.perf_counter() - t0:.1f} s "
          f"({weights_bytes / 1e9:.2f} GB), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    out = main_path_run(torch, mcfg, params, n_blocks=MOE_N_BLOCKS,
                        per_layer={ops.paged_decode_attention: 1,
                                   ops.update_kv_buffer: 0, ops.gmm_fwd: 3,
                                   ops.gmm_bwd: 0})

    # one decode step alone, the host plane's threads stopped
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    arenas, bt, cl, tok = paged_state(torch, mcfg, dev, gen,
                                      n_blocks=MOE_N_BLOCKS, max_len=1024)

    def one_step():
        with torch.no_grad():
            transformer.forward(params, mcfg, tok, cache_len=cl,
                                paged_cache=(arenas["k"], arenas["v"], bt))
    alone_ms = host_ms(torch, one_step, reps=5)
    busy_ms = device_busy_ms(torch, one_step, top=8)
    step_ops = device_busy_ms.ops
    bound = (weights_bytes - embed_bytes) / HBM_BYTES_PER_S * 1e3
    busy = "not measured" if busy_ms is None else f"{busy_ms:.3f}"
    print(f"step alone {mcfg.arch_id} (8 rows, cached lens {cl.tolist()}): "
          f"host_ms={alone_ms:.3f} device_busy_ms={busy} (bytes bound of "
          f"the weights it reads {bound:.3f} ms)", flush=True)
    host_ops(torch, one_step, top=8)
    del arenas, bt, cl, tok
    torch.cuda.empty_cache()
    return params, dict(out, weights_bytes=weights_bytes,
                        step_alone_ms=alone_ms, step_device_busy_ms=busy_ms,
                        step_device_ops=step_ops, step_bytes_bound_ms=bound)


def routing_flips(torch, mcfg, dev, *, layers: int) -> dict:
    """Phase 17b's reading of the routing: the no-cache forward of phase
    17b's first microbatch (its weights and tokens, ``layers`` layers)
    with the grouped-matmul kernels and with their plain versions, in
    bf16 and in f32 compute, counting the (token, layer) pairs whose top-k
    experts differ between the two (read through a ``moe.RoutingTap``)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import gmm_plain
    from repro_torch.models import moe
    from repro_torch.models.registry import get_api

    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 500, size=(TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)[:1, :-1]
    out = {}
    for compute in ("bfloat16", "float32"):
        scfg = dataclasses.replace(mcfg, n_layers=layers,
                                   compute_dtype=compute)
        params = get_api(scfg).init(scfg, seed=3, device=dev, master=True)
        picks = {}
        for tag, gmm in (("kernels", None), ("plain", gmm_plain)):
            seen = []
            with moe.RoutingTap(routed=lambda idx, keep: seen.append(
                    torch.sort(idx, dim=-1).values)), torch.no_grad():
                get_api(scfg).forward(params, scfg, toks,
                                      kernels=ops.Kernels(gmm=gmm))
            picks[tag] = seen
        flips = sum(int((a != b).any(-1).sum())
                    for a, b in zip(picks["kernels"], picks["plain"]))
        out[compute] = {"flips": flips, "routed": layers * toks.numel()}
        print(f"routing {mcfg.arch_id} ({compute}, {layers} layers, "
              f"{toks.numel()} tokens): top-{mcfg.top_k} sets differ "
              f"between kernels and plain versions at {flips} of "
              f"{layers * toks.numel()} (token, layer) pairs", flush=True)
        del params
        torch.cuda.empty_cache()
    return out


def moe_bucket_vs_eager(torch, mcfg, params, dev) -> dict:
    """Phase 16's gate on the bucketed server: one dense decode step of a
    bucket of 8 rows (phase 5's prompts' last tokens, cache empty) against
    each row's step alone. A row alone is one token (capacity 4, nothing
    dropped). Rows of a bucket meet only in the MoE layers' capacity, so a
    row none of whose assignments the bucket dropped, in any layer, must
    give the logits it gives alone: held to MOE_BUCKET_ULPS bf16 ulps of
    the largest |logit| (batch-of-8 and batch-of-1 products round apart).
    The rows with a drop are reported (read through a
    ``moe.RoutingTap``)."""
    import numpy as np

    from repro_torch.models import moe, transformer

    prompts, _ = make_dense_requests(np.random.default_rng(5),
                                     mcfg.vocab_size)
    last = torch.tensor([p[-1] for p in prompts[:8]], dtype=torch.int32,
                        device=dev)[:, None]
    zero = torch.zeros((8,), dtype=torch.int32, device=dev)

    def logits_of(tokens, rows):
        cache = transformer.init_cache(mcfg, rows, DENSE_LEN, device=dev)
        with torch.no_grad():
            lg, _ = transformer.forward(params, mcfg, tokens,
                                        cache_len=zero[:rows], cache=cache)
        return lg[:, -1]

    short = []                           # per token: assignments dropped
    with moe.RoutingTap(routed=lambda idx, keep: short.append(
            (~keep).sum(-1).reshape(-1))):
        bucket = logits_of(last, 8)
    alone = torch.cat([logits_of(last[i:i + 1], 1) for i in range(8)])
    lost = torch.stack(short).sum(dim=0)             # [8] over the layers
    clean = lost == 0
    amax = alone.abs().max().item()
    tol = MOE_BUCKET_ULPS * 2.0 ** (math.floor(math.log2(amax)) - 7)
    diff = (bucket - alone).abs().amax(dim=-1)
    held = diff[clean].max().item() if bool(clean.any()) else 0.0
    agree = (bucket.argmax(-1) == alone.argmax(-1)).tolist()
    print(f"bucketed vs eager {mcfg.arch_id} (one step, 8 rows): "
          f"assignments dropped per row {lost.tolist()}; logits max_abs_diff "
          f"per row {[round(x, 4) for x in diff.tolist()]} (held to {tol:g} "
          f"on the {int(clean.sum())} rows without a drop, |logit| up to "
          f"{amax:.2f}); argmax equal {agree}", flush=True)
    check(held <= tol, f"{mcfg.arch_id}: a bucket row without a dropped "
          f"assignment differs from its step alone by {held}")
    return {"dropped_per_row": lost.tolist(), "clean_rows": int(clean.sum()),
            "logits_max_abs_diff_per_row": diff.tolist(), "tol": tol,
            "held_max_abs_diff": held, "argmax_equal": agree}


# ------------------- phase 23: Moonlight-16B-A3B, the benchmark's MoE cell --

def moonlight_phase(torch, dev, flush) -> dict:
    """Moonlight-16B-A3B's path as its benchmark cell runs it (K3 at its
    head dims, (192, 128), is phase 6's ``S4096-mla-192-128-bfloat16``
    case). K6/K6b over a real dropless table: one row of TRAIN_SEQ tokens
    drawn normal, routed by the preset's router and selection bias (an MoE
    layer's weights from seed 0; ``moe.route_sigmoid``) and sorted by
    ``ops.moe_dispatch`` into its fixed table (``dispatch_rows`` rows in
    tiles of ``moe.TILE_M``, each expert's group padded with zero rows,
    the spare tiles past the last group with id E, which K6 skips); the
    gate and up product (D -> 2F) over that table, then the down product
    (F -> D) over SiLU(gate) times up of its output, each in bf16 by
    :func:`gmm_case` (phase 14's rule, control, zero checks and times),
    with dy zero on the padding rows as the combine's gradient leaves it.
    Then one train step of the cell's model (MOONLIGHT_TRAIN_LAYERS
    layers at full width, TRAIN_MICRO microbatches of one row of
    TRAIN_SEQ) through ``make_train_step``, every counter set to 0 just
    before it: under remat "full" K3 forward twice and backward once a
    layer and microbatch; K6 twice (two products) twice, K6b twice and the
    dispatch twice an MoE layer and microbatch; AdamW one norm and one
    update launch, every leaf through its kernels but the frozen selection
    bias, none through the eager route; every other counter 0."""
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import adamw as KA
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer
    from repro_torch.models.module import FROZEN, ParamBuilder
    from repro_torch.optim import AdamW
    from repro_torch.port_configs import MOONLIGHT
    from repro_torch.train.steps import make_train_step

    F = torch.nn.functional
    cfg = dataclasses.replace(MOONLIGHT, n_layers=MOONLIGHT_TRAIN_LAYERS)
    E, D, F_, K, tm = (cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k,
                       MOE.TILE_M)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    pb = ParamBuilder(0, lambda path: torch.float32, dev)
    MOE.init_moe_dropless(pb, cfg)
    mp = pb.params["moe"]
    x = torch.randn(TRAIN_SEQ, D, generator=gen, device=dev).bfloat16()
    with torch.no_grad():
        _, idx = MOE.route_sigmoid(mp, cfg, x)
        table, te, slot, routed = ops.moe_dispatch(x, idx, n_experts=E,
                                                   tile_m=tm)
    rows, assignments = table.shape[0], TRAIN_SEQ * K
    used = torch.zeros(rows, dtype=torch.bool, device=dev)
    used[slot] = True
    routed = routed.tolist()
    spare = int((te == E).sum())
    check(rows == ops.dispatch_rows(assignments, E, tm)
          and sum(routed) == assignments and int(used.sum()) == assignments
          and spare > 0, f"moonlight: a table of {rows} rows with "
          f"{int(used.sum())} routed of {assignments} and {spare} spare "
          f"tiles")
    wi, wo = (mp[n].bfloat16() for n in ("wi", "wo"))
    with torch.no_grad():
        h = mg.gmm_fwd(table, wi, te, tm)
        h = F.silu(h[:, :F_]) * h[:, F_:]
    cases = {"fwd": [], "bwd": []}
    for label, xin, w in (("dropless-wi", table, wi),
                          ("dropless-wo", h, wo)):
        dy = torch.randn(rows, w.shape[2], generator=gen,
                         device=dev).bfloat16()
        dy[~used] = 0
        entries = gmm_case(torch, mg, flush, label, xin, w, dy, te, tm,
                           reps=10)
        for kind in cases:
            cases[kind].append(entries[kind])
        del dy
    table_share = {"routed_rows": assignments, "table_rows": rows,
                   "padding_rows_in_groups": rows - assignments - spare * tm,
                   "spare_tiles": spare,
                   "routed_share": assignments / rows,
                   "load_max_over_mean": max(routed) / (sum(routed) / E)}
    print(f"moonlight dropless table: {table_share}", flush=True)
    del pb, mp, x, table, te, slot, used, h, wi, wo
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    params = transformer.init(cfg, seed=0, device=dev, master=True)
    paths = leaf_paths(params)
    n_leaves = len(paths)
    frozen = sum(path.rsplit("/", 1)[-1] in FROZEN for path in paths)
    n_params = sum(t.numel() for t in flatten(params))
    step, opt = make_train_step(cfg, TrainConfig(microbatches=TRAIN_MICRO))
    state = opt.init(params)
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_MICRO, TRAIN_SEQ),
                        generator=gen, device=dev)
    batch = {"tokens": tok, "labels": tok}
    counters = [getattr(ops, n) for n in KERNEL_COUNTERS]
    for c in counters:
        c.launches = 0
    KA.adamw_sqnorm.launches = KA.adamw_update.launches = 0
    AdamW.fused_leaves = AdamW.plain_leaves = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, metrics = step(params, state, batch)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    step_s = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    adamw = {"sqnorm_launches": KA.adamw_sqnorm.launches,
             "update_launches": KA.adamw_update.launches,
             "fused_leaves": AdamW.fused_leaves,
             "plain_leaves": AdamW.plain_leaves}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    Lall, Lm, mb = cfg.n_layers, cfg.n_moe_layers, TRAIN_MICRO
    expected = {"flash_attention_fwd": 2 * Lall * mb,
                "flash_attention_bwd": Lall * mb,
                "gmm_fwd": 2 * 2 * Lm * mb, "gmm_bwd": 2 * Lm * mb,
                "moe_dispatch": 2 * Lm * mb}
    print(f"moonlight train step: {cfg.arch_id} full width, {Lall} layers "
          f"({n_params / 1e9:.3f} B params, {n_leaves} leaves of which "
          f"{frozen} frozen), {mb}x{TRAIN_SEQ} tokens in {mb} microbatches: "
          f"loss {loss:.4f} grad_norm {gnorm:.4f} in {step_s:.2f} s (the "
          f"first step) peak_mem={peak_gb:.2f} GB; launches={launches} "
          f"adamw={adamw}", flush=True)
    check(math.isfinite(loss) and math.isfinite(gnorm),
          f"moonlight: loss {loss}, grad norm {gnorm}")
    for name, n in launches.items():
        check(n == expected.get(name, 0), f"moonlight train step: {name} "
              f"launched {n} times, expected {expected.get(name, 0)}")
    check(adamw == {"sqnorm_launches": 1, "update_launches": 1,
                    "fused_leaves": n_leaves - frozen, "plain_leaves": 0},
          f"moonlight train step: AdamW {adamw} over {n_leaves} leaves, "
          f"{frozen} frozen")
    del params, state, metrics, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.arch_id, "layers": Lall, "params": n_params,
            "leaves": n_leaves, "frozen_leaves": frozen, "loss": loss,
            "grad_norm": gnorm, "first_step_s": step_s,
            "peak_mem_gb": peak_gb, "launches": launches, "adamw": adamw,
            "gmm_cases": cases, "table": table_share, "routed": routed}


# ------------------------------- phase 18: device-initiated syscalls ----

PAGE = 4096
FIG5_MB = (1, 4, 16)
FIG6_GROUPS, FIG6_BLOCK, FIG6_ITERS = 16, 8192, (1, 8, 32)
FIG7_CALLS, FIG7_KB = 64, (4, 64, 512)
INVOKE_REPS = 3              # host-clock reps of each Fig. 5-7 workload
ROUND_TRIP_REPS = 30         # reps of each round-trip timing
BARE_SLOTS = 64              # slots of the bare responder's area
TIMEOUT_CHECK_S = 2.0        # the bound of phase 18's timeout check
# the stamps of the invoke kernel's stamped build (csrc/genesys_protocol.cuh)
INVOKE_CARD_PARTS = {"entry_to_owner": (0, 1), "owner_to_ready": (1, 2),
                     "ready_to_finished": (2, 3), "finished_to_exit": (3, 4),
                     "entry_to_exit": (0, 4)}


def stamped_invoke_build() -> Path:
    """The invoke kernel built with GENESYS_INVOKE_STAMPS: each row records
    %globaltimer at entry, owner taken, READY stored, FINISHED seen and
    exit, and the backoff the paced wait replaced is kept beside it. A copy
    of ``genesys_invoke.cu``, the headers and ``_build.py`` under build/,
    the macro defined at the top of ``genesys_protocol.cuh`` (as
    ``experiments/torch_invoke_latency.py --stamps`` copies the whole
    tree), built by the copy's own ``build()``. Returns the library."""
    import importlib.util

    from repro_torch.kernels import _build
    dst = ROOT / "build" / "invoke_stamps" / "src" / "repro_torch" / "kernels"
    shutil.rmtree(dst, ignore_errors=True)
    (dst / "csrc").mkdir(parents=True)
    shutil.copy2(_build.__file__, dst / "_build.py")
    for src in [_build.CSRC / "genesys_invoke.cu", *_build.headers()]:
        shutil.copy2(src, dst / "csrc" / src.name)
    proto = dst / "csrc" / "genesys_protocol.cuh"
    text = proto.read_text()
    check("#pragma once\n" in text, f"no '#pragma once' in {proto.name}")
    proto.write_text(text.replace(
        "#pragma once\n", "#pragma once\n#define GENESYS_INVOKE_STAMPS 1\n",
        1))
    spec = importlib.util.spec_from_file_location("invoke_stamps_build",
                                                  dst / "_build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    return build.build()


def stamped_call(torch, lib, stamped_lib, call, rows: int) -> dict:
    """Run ``call()`` once with the invoke kernel's launch taken from the
    stamped build (same arguments; the kernel library's entry point is put
    back after), and return row 0's card intervals in µs (card clock)."""
    import ctypes

    from repro_torch.kernels import _build
    stamped = ctypes.CDLL(str(stamped_lib))
    launch = stamped.genesys_invoke_launch
    launch.argtypes, launch.restype = _build.SIGNATURES[
        "genesys_invoke_launch"]
    read = stamped.genesys_invoke_stamps_read
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    path = lib.genesys_invoke_launch
    lib.genesys_invoke_launch = launch
    try:
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
    finally:
        lib.genesys_invoke_launch = path
    buf = (ctypes.c_ulonglong * (5 * rows))()
    check(read(ctypes.addressof(buf), len(buf)) == 0,
          "genesys_invoke_stamps_read failed")
    return {part: (buf[j] - buf[i]) / 1e3
            for part, (i, j) in INVOKE_CARD_PARTS.items()}


def invoke_phase(torch, dev, stamped_lib) -> dict:
    """Phase 18: ``Genesys.invoke`` on the card against its plain host
    entry (the same call on CPU tensors), at the reference's sizes: the
    quickstart's read, Fig. 5's granularities, Fig. 6's orderings, Fig.
    7's coalescing and the ring, the rule errors, a control, a timeout.
    ``stamped_lib``: :func:`stamped_invoke_build`'s library, through
    which one call of each round trip is cut on the card's clock."""
    import numpy as np
    from repro_torch.core.genesys import (Genesys, GenesysConfig,
                                          Granularity as Gr, Ordering as Or,
                                          Sys)
    from repro_torch.core.genesys.invoke import pack_args
    from repro_torch.kernels import _build
    from repro_torch.kernels import genesys_invoke as gi

    work = ROOT / "build" / "smoke_invoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cpu = torch.device("cpu")
    out = {"reps": INVOKE_REPS}
    gi.post_rows.launches = 0
    calls = [0]                  # device invocations of the main drive
    max_err = [0]                # |device retval - plain retval|, all calls

    def make_file(name: str, nbytes: int, seed: int) -> Path:
        path = work / name
        np.random.default_rng(seed).integers(
            0, 256, nbytes, dtype=np.uint8).tofile(path)
        return path

    def open_ro(g, path: Path) -> int:
        fd = g.call(Sys.OPEN, g.heap.register_bytes(str(path).encode()),
                    os.O_RDONLY, 0)
        check(fd >= 0, f"open {path}: {fd}")
        return fd

    def heap_bytes(g, h) -> bytes:
        return np.asarray(g.heap.resolve(h)).tobytes()

    def same_rets(got, want, what: str) -> None:
        got, want = got.cpu().numpy(), want.cpu().numpy()
        check(got.shape == want.shape, f"{what}: retval shape {got.shape} "
              f"vs {want.shape}")
        max_err[0] = max(max_err[0], int(np.abs(
            got.astype(np.int64) - want.astype(np.int64)).max(initial=0)))
        check((got == want).all(), f"{what}: retvals differ from the plain "
              f"entry's: {got.ravel()[:8]} vs {want.ravel()[:8]}")

    def timed(fn, reps: int = INVOKE_REPS) -> tuple[float, object]:
        ts, res = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts), res

    # the quickstart (examples/quickstart.py): a work-group pread with no
    # pre-dependency, its result tied into the step's output
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    try:
        path = work / "quickstart.f32"
        np.arange(256, dtype=np.float32).tofile(path)
        fd = open_ro(g, path)
        rets = {}
        for where in (dev, cpu):
            buf = g.heap.new_buffer(1024)
            x = torch.ones(4, device=where)
            res = g.invoke(Sys.PREAD64, pack_args(fd, buf, 1024, 0,
                                                  device=where),
                           granularity=Gr.WORK_GROUP,
                           ordering=Or.RELAXED_CONSUMER, blocking=True,
                           deps=x)
            y, n = res.tie(x * 2.0), res.ret64()
            rets[where.type] = res.retval
            check(bool((y.cpu() == 2.0).all()), f"quickstart {where}: y {y}")
            check(int(n) == 1024, f"quickstart {where}: pread returned {n}")
            check(heap_bytes(g, buf) == path.read_bytes(),
                  f"quickstart {where}: the buffer is not the file")
            g.heap.release(buf)
        calls[0] += 1
        same_rets(rets["cuda"], rets["cpu"], "quickstart")
        g.call(Sys.CLOSE, fd)
        plane = g.device_plane(dev)
        out["device_attributes"] = plane.attributes
        # the mapped area's poller waits in the native doorbell (C, the GIL
        # released), never in the Python scan
        out["native_doorbell"] = bool(plane.poller.native
                                      and plane.poller._doorbell
                                      == gi.doorbell())
        check(out["native_doorbell"], "phase 18: the mapped area's poller "
              "does not wait in the native doorbell")
        print(f"phase 18: {torch.cuda.get_device_name(0)} "
              f"cudaDevAttrHostNativeAtomicSupported="
              f"{plane.attributes['host_native_atomics']} "
              f"(the protocol relies on it either way: no); "
              f"{plane.area.n_slots} slots in mapped host memory; the "
              f"poller waits in the native doorbell", flush=True)
    finally:
        g.shutdown()

    # Fig. 5: pread of 1, 4 and 16 MB at work-item (4 KB pages), work-group
    # (64 pages) and kernel granularity (benchmarks/fig5_granularity.py)
    fig5 = []
    g = Genesys(GenesysConfig(n_workers=4, coalesce_window_us=100,
                              coalesce_max=16))
    try:
        for mb in FIG5_MB:
            nbytes = mb << 20
            path = make_file(f"fig5_{mb}MB.bin", nbytes, seed=mb)
            want = path.read_bytes()
            fd = open_ro(g, path)
            for gran, chunk in ((Gr.WORK_ITEM, PAGE),
                                (Gr.WORK_GROUP, 64 * PAGE),
                                (Gr.KERNEL, nbytes)):
                n_chunks = nbytes // chunk
                row = {"MB": mb, "granularity": gran.value, "calls": 1 if
                       gran == Gr.WORK_ITEM else n_chunks, "rows": n_chunks}
                rets = {}
                for where in (dev, cpu):
                    bh = g.heap.new_buffer(nbytes)
                    x = torch.zeros(1, device=where)
                    if gran == Gr.WORK_ITEM:
                        args = torch.stack([pack_args(
                            fd, bh, chunk, i * chunk, i * chunk,
                            device="cpu") for i in range(n_chunks)]).to(where)

                        def step():
                            return g.invoke(
                                Sys.PREAD64, args, granularity=gran,
                                ordering=Or.STRONG, blocking=True).ret64()
                    else:
                        packed = [pack_args(fd, bh, chunk, i * chunk,
                                            i * chunk, device=where)
                                  for i in range(n_chunks)]

                        def step():
                            return torch.stack([g.invoke(
                                Sys.PREAD64, a, granularity=gran,
                                ordering=Or.RELAXED_CONSUMER, blocking=True,
                                deps=x).ret64() for a in packed])
                    g.drain()
                    irq0 = g.executor.stats.interrupts
                    ms, ret = timed(step)
                    g.drain()
                    irqs = g.executor.stats.interrupts - irq0
                    check(irqs == INVOKE_REPS * n_chunks,
                          f"fig5 {mb} MB {gran.value} on {where.type}: "
                          f"{irqs} interrupts for {INVOKE_REPS} x "
                          f"{n_chunks} rows")
                    check(bool((ret.cpu() == chunk).all()),
                          f"fig5 {mb} MB {gran.value} on {where.type}: "
                          f"retvals {ret.cpu()[:4]}")
                    check(heap_bytes(g, bh) == want,
                          f"fig5 {mb} MB {gran.value} on {where.type}: the "
                          f"buffer is not the file")
                    rets[where.type] = ret
                    row[f"{where.type}_ms"] = ms
                    row[f"{where.type}_interrupts"] = irqs // INVOKE_REPS
                    g.heap.release(bh)
                calls[0] += INVOKE_REPS * row["calls"]
                same_rets(rets["cuda"], rets["cpu"],
                          f"fig5 {mb} MB {gran.value}")
                print(f"fig5 pread {mb} MB {gran.value}: {row['rows']} rows "
                      f"in {row['calls']} calls, device {row['cuda_ms']:.3f} "
                      f"ms, plain {row['cpu_ms']:.3f} ms, interrupts "
                      f"{row['cuda_interrupts']} a run", flush=True)
                fig5.append(row)
            g.call(Sys.CLOSE, fd)
    finally:
        g.shutdown()
    out["fig5"] = fig5

    # Fig. 6: 16 blocks of 8 KB permuted on the card, then pwritten at
    # work-group granularity in the four {strong, weak} x {blocking,
    # non-blocking} modes (benchmarks/fig6_ordering.py)
    fig6 = []
    g = Genesys(GenesysConfig(n_workers=4))
    try:
        path = work / "fig6.bin"
        fd = g.call(Sys.OPEN, g.heap.register_bytes(str(path).encode()),
                    os.O_CREAT | os.O_WRONLY, 0o644)
        out_h = g.heap.new_buffer(FIG6_GROUPS * FIG6_BLOCK)
        perm = torch.as_tensor(np.random.default_rng(0).permutation(
            FIG6_BLOCK), device=dev)
        data = torch.as_tensor(np.random.default_rng(1).integers(
            0, 255, size=(FIG6_GROUPS, FIG6_BLOCK), dtype=np.uint8).astype(
                np.float32), device=dev)
        packed = [pack_args(fd, out_h, FIG6_BLOCK, i * FIG6_BLOCK,
                            i * FIG6_BLOCK, device=dev)
                  for i in range(FIG6_GROUPS)]
        modes = {"strong-block": (Or.STRONG, True),
                 "strong-nonblock": (Or.STRONG, False),
                 "weak-block": (Or.RELAXED_PRODUCER, True),
                 "weak-nonblock": (Or.RELAXED_PRODUCER, False)}
        for iters in FIG6_ITERS:
            for name, (ordering, blocking) in modes.items():
                def step():
                    y = data
                    for _ in range(iters):
                        y = y[:, perm]
                    outs, rets = y.sum(), []
                    for a in packed:
                        res = g.invoke(Sys.PWRITE64, a,
                                       granularity=Gr.WORK_GROUP,
                                       ordering=ordering, blocking=blocking,
                                       deps=y)
                        if blocking:
                            outs = res.tie(outs)
                            rets.append(res.ret64())
                    return outs, rets

                def once():
                    res = step()
                    g.drain()
                    return res
                os.truncate(path, 0)
                ms, (outs, rets) = timed(once)
                check(path.stat().st_size == FIG6_GROUPS * FIG6_BLOCK,
                      f"fig6 {name} x{iters}: the file holds "
                      f"{path.stat().st_size} bytes")
                check(bool(torch.isfinite(outs)), f"fig6 {name}: {outs}")
                check(all(int(r) == FIG6_BLOCK for r in rets),
                      f"fig6 {name}: pwrite returned {rets}")
                calls[0] += INVOKE_REPS * FIG6_GROUPS
                fig6.append({"iters": iters, "mode": name, "ms": ms,
                             "us_per_iter": 1e3 * ms / iters})
                print(f"fig6 iters {iters} {name}: {ms:.3f} ms", flush=True)
        g.call(Sys.CLOSE, fd)
    finally:
        g.shutdown()
    out["fig6"] = fig6

    # Fig. 7: 64-row work-item preads of 4, 64 and 512 KB without and with
    # interrupt coalescing (benchmarks/fig7_coalescing.py)
    fig7 = []
    for label, kw in (("nocoalesce", dict(coalesce_window_us=0,
                                          coalesce_max=1)),
                      ("coalesce8", dict(coalesce_window_us=300,
                                         coalesce_max=8))):
        gs = {w: Genesys(GenesysConfig(n_workers=2, **kw))
              for w in ("cuda", "cpu")}
        try:
            path = make_file(f"fig7_{label}.bin", 8 << 20, seed=7)
            fds = {w: open_ro(gw, path) for w, gw in gs.items()}
            for kb in FIG7_KB:
                nb = kb << 10
                rets, bufs, row = {}, {}, {"coalesce": label, "KB": kb}
                for where in (dev, cpu):
                    gw = gs[where.type]
                    bh = gw.heap.new_buffer(nb * FIG7_CALLS)
                    args = torch.stack([pack_args(
                        fds[where.type], bh, nb, i * nb, i * nb,
                        device="cpu") for i in range(FIG7_CALLS)]).to(where)
                    ms, ret = timed(lambda: gw.invoke(
                        Sys.PREAD64, args, granularity=Gr.WORK_ITEM,
                        ordering=Or.STRONG, blocking=True).ret64())
                    rets[where.type] = ret
                    bufs[where.type] = heap_bytes(gw, bh)
                    row[f"{where.type}_ms"] = ms
                    gw.heap.release(bh)
                calls[0] += INVOKE_REPS
                same_rets(rets["cuda"], rets["cpu"], f"fig7 {label} {kb} KB")
                check(bufs["cuda"] == bufs["cpu"],
                      f"fig7 {label} {kb} KB: the buffers differ")
                fig7.append(row)
            for w, gw in gs.items():
                gw.drain()
                hist = dict(gw.executor.stats.coalesce_hist)
                fig7.append({"coalesce": label, "entry": w,
                             "coalesce_hist": hist,
                             "mean_bundle": gw.executor.stats.mean_coalesce()})
                if w == "cuda" and label == "nocoalesce":
                    check(max(hist) == 1, f"fig7 nocoalesce: bundles {hist}")
                if w == "cuda" and label == "coalesce8":
                    check(1 < max(hist) <= 8, f"fig7 coalesce8: bundles "
                          f"{hist}")
                print(f"fig7 {label} {w}: bundles {sorted(hist.items())}, "
                      f"mean {gw.executor.stats.mean_coalesce():.2f}",
                      flush=True)
            for w, gw in gs.items():
                gw.call(Sys.CLOSE, fds[w])
        finally:
            for gw in gs.values():
                gw.shutdown()
    for row in fig7:
        if "KB" in row:
            print(f"fig7 {row['coalesce']} {row['KB']} KB x {FIG7_CALLS}: "
                  f"device {row['cuda_ms']:.3f} ms, plain "
                  f"{row['cpu_ms']:.3f} ms", flush=True)
    out["fig7"] = fig7

    # the ring (tests/test_uring.py's invoke via_ring case), blocking and
    # not: the same results and ring counters as the plain entry's
    ring = {}
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    try:
        path = work / "ring.bin"
        path.write_bytes(bytes(range(64)))
        fd = open_ro(g, path)
        for blocking in (True, False):
            rets = {}
            for where in (dev, cpu):
                bh = g.heap.new_buffer(64)
                args = torch.stack([pack_args(fd, bh, 16, 16 * i, 16 * i,
                                              device="cpu")
                                    for i in range(4)]).to(where)
                g.drain()
                s0 = g.executor.counters.snapshot()
                res = g.invoke(Sys.PREAD64, args,
                               granularity=Gr.WORK_ITEM,
                               ordering=Or.STRONG, blocking=blocking,
                               via_ring=True)
                g.drain()
                s1 = g.executor.counters.snapshot()
                d = {k: s1[k] - s0[k] for k in ("interrupts", "processed",
                                                 "ring_processed")}
                check(d == {"interrupts": 0, "processed": 4,
                            "ring_processed": 4},
                      f"ring on {where.type}: counters moved by {d}")
                check(heap_bytes(g, bh) == bytes(range(64)),
                      f"ring on {where.type}: the buffer is not the file")
                check((res.retval is None) == (not blocking),
                      f"ring on {where.type}: retval {res.retval}")
                rets[where.type] = res.retval
                ring[f"{where.type}_{'block' if blocking else 'nonblock'}"] \
                    = d
                g.heap.release(bh)
            calls[0] += 1
            if blocking:
                same_rets(rets["cuda"], rets["cpu"], "ring")
                check(rets["cuda"][:, 0].tolist() == [16] * 4,
                      f"ring: retvals {rets['cuda']}")
        out["ring"] = ring
        launches = gi.post_rows.launches
        check(launches == calls[0], f"phase 18 launched the kernel "
              f"{launches} times for {calls[0]} device calls")

        # the rules, raised before anything is launched
        irq0 = g.executor.stats.interrupts
        one = pack_args(0, device=dev)
        for what, kw in (("deadlock", dict(granularity=Gr.KERNEL,
                                           ordering=Or.STRONG)),
                         ("implicit strong", dict(
                             granularity=Gr.WORK_ITEM,
                             ordering=Or.RELAXED_PRODUCER)),
                         ("batched args", dict(
                             granularity=Gr.WORK_GROUP,
                             ordering=Or.RELAXED_CONSUMER))):
            a = one[None] if what == "batched args" else one
            try:
                g.invoke(Sys.CLOCK_GETTIME, a, **kw)
            except ValueError as e:
                check(what in str(e), f"rule {what}: raised {e}")
            else:
                raise SmokeFailure(f"rule {what}: nothing raised")
        check(gi.post_rows.launches == launches
              and g.executor.stats.interrupts == irq0,
              "a refused call launched or rang")

        # the control: Fig. 5's 1 MB work-item batch, every file offset one
        # page on, must fail the byte comparison
        path = work / "fig5_1MB.bin"
        want = path.read_bytes()
        fd1 = open_ro(g, path)
        bh = g.heap.new_buffer(1 << 20)
        args = torch.stack([pack_args(fd1, bh, PAGE, (i + 1) * PAGE,
                                      i * PAGE, device="cpu")
                            for i in range(256)]).to(dev)
        ret = g.invoke(Sys.PREAD64, args, granularity=Gr.WORK_ITEM,
                       ordering=Or.STRONG, blocking=True).ret64().cpu()
        control_equal = heap_bytes(g, bh) == want
        check(not control_equal, "control: pages read one page on still "
              "equal the file")
        out["control"] = {"bytes_equal": control_equal,
                          "retvals_0": int((ret == 0).sum())}
        g.heap.release(bh)
        g.call(Sys.CLOSE, fd1)
        g.call(Sys.CLOSE, fd)
    finally:
        g.shutdown()

    # round trips of one blocking CLOCK_GETTIME at each granularity, and of
    # a 64-row work-item batch; device time from CUDA events around the
    # call, host time of the call and a sync; the plain entry's host time
    rt = []
    g = Genesys(GenesysConfig(n_workers=2))
    try:
        for label, gran, ordering, n in (
                ("work_item", Gr.WORK_ITEM, Or.STRONG, 1),
                ("work_group", Gr.WORK_GROUP, Or.STRONG, 0),
                ("kernel", Gr.KERNEL, Or.RELAXED_CONSUMER, 0),
                ("work_item_64", Gr.WORK_ITEM, Or.STRONG, 64)):
            row = {"call": label, "rows": max(n, 1)}
            for where in (dev, cpu):
                a = pack_args(0, device=where)
                if n:
                    a = a.expand(n, 6, 2).contiguous()
                dev_ms, host_ms = [], []
                for _ in range(ROUND_TRIP_REPS):
                    if where.type == "cuda":
                        torch.cuda.synchronize()
                        s, e = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                        t0 = time.perf_counter()
                        s.record()
                        res = g.invoke(Sys.CLOCK_GETTIME, a,
                                       granularity=gran, ordering=ordering)
                        e.record()
                        torch.cuda.synchronize()
                        host_ms.append(1e3 * (time.perf_counter() - t0))
                        dev_ms.append(s.elapsed_time(e))
                    else:
                        t0 = time.perf_counter()
                        res = g.invoke(Sys.CLOCK_GETTIME, a,
                                       granularity=gran, ordering=ordering)
                        host_ms.append(1e3 * (time.perf_counter() - t0))
                    check(bool((res.retval[..., 1].cpu() >= 0).all()
                               and (res.ret64().cpu() != 0).any()),
                          f"round trip {label}: retval {res.retval}")
                if where.type == "cuda":
                    row["ms"] = statistics.median(dev_ms)
                    row["host_ms"] = statistics.median(host_ms)
                    row["card_us"] = stamped_call(
                        torch, _build.library(), stamped_lib,
                        lambda: g.invoke(Sys.CLOCK_GETTIME, a,
                                         granularity=gran,
                                         ordering=ordering), row["rows"])
                else:
                    row["plain_ms"] = statistics.median(host_ms)
            # the bytes a call must move: its args read, a slot line
            # written and its retval written, per row
            row["bound_ms"] = bound_ms(row["rows"] * (48 + 64 + 8), 0,
                                       "float32")[0]
            rt.append(row)
            c = row["card_us"]
            print(f"round trip {label} ({row['rows']} rows): device "
                  f"{row['ms']:.4f} ms, with launch and sync "
                  f"{row['host_ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                  f"ms; one call on the card's clock (row 0): entry to "
                  f"owner {c['entry_to_owner']:.2f} us, owner to READY "
                  f"{c['owner_to_ready']:.2f}, READY to FINISHED seen "
                  f"{c['ready_to_finished']:.2f}, FINISHED to exit "
                  f"{c['finished_to_exit']:.2f}, entry to exit "
                  f"{c['entry_to_exit']:.2f}", flush=True)
    finally:
        g.shutdown()
    out["round_trip"] = rt
    out["bare_round_trip"], out["bare_round_trip_old_wait"] = \
        bare_round_trip(torch, dev, stamped_lib)

    # the bound: with the poller stopped, a blocking call gives up after
    # its bound, returns -ETIMEDOUT and the next barrier raises
    g = Genesys(GenesysConfig(n_workers=2))
    try:
        plane = g.device_plane(dev)
        plane.timeout_s = TIMEOUT_CHECK_S
        plane.poller.stop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = g.invoke(Sys.CLOCK_GETTIME, pack_args(0, device=dev),
                       granularity=Gr.WORK_GROUP, ordering=Or.STRONG)
        torch.cuda.synchronize()
        waited = time.perf_counter() - t0
        ret = int(res.ret64())
        try:
            g.drain()
        except TimeoutError as e:
            raised = str(e)
        else:
            raised = None
        check(raised is not None, "timeout: drain did not raise")
        check(ret == -gi.ETIMEDOUT, f"timeout: retval {ret}")
        check(TIMEOUT_CHECK_S <= waited < TIMEOUT_CHECK_S + 3.0,
              f"timeout: the call took {waited:.2f} s for a "
              f"{TIMEOUT_CHECK_S} s bound")
        out["timeout"] = {"bound_s": TIMEOUT_CHECK_S, "waited_s": waited,
                          "retval": ret, "raised": raised}
        print(f"timeout check: the call gave up after {waited:.3f} s "
              f"(bound {TIMEOUT_CHECK_S} s), retval {ret}, drain raised "
              f"'{raised}'", flush=True)
    finally:
        g.shutdown()
    shutil.rmtree(work, ignore_errors=True)
    out["launches"] = launches
    out["max_abs_err"] = max_err[0]
    return out


def bare_round_trip(torch, dev, stamped_lib) -> tuple[dict, dict]:
    """The floor of any device entry's round trip, ``Genesys.invoke``'s
    bound: one blocking row posted by the invoke kernel into a mapped area
    of its own, through the same 64-byte slot protocol, and answered by a
    bare host responder (``genesys_bare_respond`` in
    ``csrc/genesys_invoke.cu``: READY rows marked FINISHED at once, with
    no executor, dispatcher or handler) spinning in C on a thread of its
    own, the GIL released. Device time from CUDA events around the call,
    median of ``ROUND_TRIP_REPS``; the path's paced wait and, in turns
    with it, the exponential backoff it replaced (the stamped build's
    ``genesys_invoke_backoff_launch``, put in the launch's place for those
    calls). Returns (paced, backoff)."""
    import ctypes

    from repro_torch.core.genesys import Sys
    from repro_torch.core.genesys.area import SLOT_BYTES
    from repro_torch.core.genesys.device import DeviceSyscallArea
    from repro_torch.kernels import _build
    from repro_torch.kernels import genesys_invoke as gi

    # a CDLL handle releases the GIL for the call (the library's own
    # PyDLL handle keeps it)
    respond = ctypes.CDLL(str(_build.build())).genesys_bare_respond
    respond.argtypes, respond.restype = _build.SIGNATURES[
        "genesys_bare_respond"]
    lib = _build.library()
    backoff = ctypes.CDLL(str(stamped_lib)).genesys_invoke_backoff_launch
    backoff.argtypes, backoff.restype = _build.SIGNATURES[
        "genesys_invoke_launch"]
    waits = {"paced": lib.genesys_invoke_launch, "backoff": backoff}
    nbytes = (BARE_SLOTS + 1) * SLOT_BYTES
    host, dev_ptr = gi.alloc_mapped(nbytes, dev)
    launches = gi.post_rows.launches
    ms = {w: [] for w in waits}
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
            for i in range(ROUND_TRIP_REPS + 2):      # 2 warm-up rounds
                for w, entry in waits.items():
                    lib.genesys_invoke_launch = entry
                    torch.cuda.synchronize()
                    s, e = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                    s.record()
                    ret = gi.post_rows(area, owner, rows, base=i,
                                       sysno=int(Sys.CLOCK_GETTIME), flags=1,
                                       hw_id=0, timeout_s=2.0)
                    e.record()
                    torch.cuda.synchronize()
                    check(int(area.status[0]) == 0 and not bool(ret.any()),
                          f"bare round trip {i} ({w} wait): status "
                          f"{area.status[:2]}, retval {ret.tolist()}")
                    if i >= 2:
                        ms[w].append(s.elapsed_time(e))
        finally:
            lib.genesys_invoke_launch = waits["paced"]
            stop.value = 1
            responder.join(timeout=10)
        check(not responder.is_alive(), "the bare responder did not stop")
        n = len(waits) * (ROUND_TRIP_REPS + 2)
        check(answered.value == n, f"the bare responder answered "
              f"{answered.value} rows of {n}")
    finally:
        gi.free_mapped(host)
    gi.post_rows.launches = launches      # measurement, not the path
    paced, backoff = ({"ms": statistics.median(ms[w]), "min_ms": min(ms[w]),
                       "reps": ROUND_TRIP_REPS, "rows": 1, "wait": w}
                      for w in waits)
    print(f"bare round trip (1 blocking row, host responder without "
          f"executor): device {paced['ms']:.4f} ms (min "
          f"{paced['min_ms']:.4f}) with the paced wait, "
          f"{backoff['ms']:.4f} ms (min {backoff['min_ms']:.4f}) with the "
          f"backoff it replaced, in turns", flush=True)
    return paced, backoff


# ---------------------------------------- phase 19: the encoder-decoder --

def cut_cross(q, k, v, lens, k_new=None, v_new=None):
    """Phase 19a's control: the plain decode attention, with the
    cross-attention (the call without a new token) cut to the first
    ENCDEC_CUT_LENS encoder positions."""
    from repro_torch.kernels import ops
    if k_new is None:
        lens = lens.clamp(max=ENCDEC_CUT_LENS)
    return ops.decode_attention_plain(q, k, v, lens, k_new, v_new)


def cross_attention_case(torch, cfg, dev, flush) -> dict:
    """The decode step's cross-attention at seamless's shape: one query
    row a request over the encoder's 4096 positions (B = 4, H = KV = 16, hd
    64, bf16), through K2 (``ops.decode_attention`` with no new token, the
    path's route) and through K3a at Sq = 1 (the alternative), against the
    plain version, SDPA, and the bytes bound (K and V read once)."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    B, S, h, kv, hd = (ENCDEC_ROWS, cfg.n_frame_tokens, cfg.n_heads,
                       cfg.n_kv_heads, cfg.hd)
    q = torch.randn(B, h, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, kv, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn(B, S, kv, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    want = ops.decode_attention_plain(q, k, v, lens)
    got = ops.decode_attention(q, k, v, lens)
    fa = ops.flash_attention_fwd(q[:, None], k, v, causal=False)[0][:, 0]
    torch.cuda.synchronize()
    tol = tolerance("bfloat16", want)
    err = (got.float() - want.float()).abs().max().item()
    fa_err = (fa.float() - want.float()).abs().max().item()
    check(err <= tol, f"cross-attention K2 error {err} > {tol}")
    check(fa_err <= tol, f"cross-attention K3a (Sq 1) error {fa_err} > {tol}")
    nbytes = 2 * B * S * kv * hd * 2 + 2 * q.numel() * 2
    bnd, by = bound_ms(nbytes, 4.0 * B * S * h * hd, "bfloat16")
    ms, _ = cuda_ms(torch, lambda: ops.decode_attention(q, k, v, lens),
                    reps=20, flush=flush)
    fa_ms, _ = cuda_ms(torch, lambda: ops.flash_attention_fwd(
        q[:, None], k, v, causal=False), reps=20, flush=flush)
    plain_ms, _ = cuda_ms(torch, lambda: ops.decode_attention_plain(
        q, k, v, lens), reps=5, flush=flush)
    library_ms, _ = cuda_ms(torch, lambda: library_dense_attention(
        torch, q, k, v, lens), reps=10, flush=flush)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = tda.ring_splits(B, kv, S, n_sm, tda.min_split(hd))
    case = {"case": f"seamless-cross-B{B}-S{S}-bfloat16-cache",
            "heads": [h, kv, hd], "variant": tda.variant(q.dtype, hd),
            "splits_per_row": splits, "max_abs_err": err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bnd, "bound_by": by, "kv_bytes": nbytes,
            "flash_fwd_sq1_ms": fa_ms, "flash_fwd_sq1_max_abs_err": fa_err,
            "lens": lens.tolist()}
    print(f"kernel decode_attention[{case['case']}] ({case['variant']}, "
          f"{splits} splits a row and KV head): max_abs_err={err:.3e} (tol "
          f"{tol:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(sdpa)="
          f"{library_ms:.4f} bound_ms={bnd:.4f} ({by}, {nbytes} B); K3a at "
          f"Sq 1: ms={fa_ms:.4f} max_abs_err={fa_err:.3e}", flush=True)
    return case


def encdec_serve_phase(torch, cfg, dev) -> dict:
    """Phase 19a: seamless-m4t-medium served at the step level, as the
    reference's own test serves it (its servers do not take this family):
    ``encode`` once over ENCDEC_ROWS requests of 4096 frames, then every
    prompt fed one token a step through ``make_serve_step(cfg)(params,
    cache, tok, cache_len, enc_out)`` over a carried cache, and decoded
    greedily to its budget. A row that has spent its budget stays where it
    is (same token, same cache_len) until the longest is done, so the rows'
    cache lengths are ragged. Gates: the launches as predicted; the served
    tokens equal a teacher-forced replay's argmax; decode equals prefill
    (bf16 logits within LOGITS_ATOL_BF16, and greedy tokens at 2 + 2 layers
    in f32 wherever the margin exceeds MARGIN_F32); one decode step and one
    no-cache forward with the kernels against the plain attention, and a
    control (the cross-attention cut to ENCDEC_CUT_LENS positions) that
    must fail that check."""
    import numpy as np

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    from repro_torch.models import layers as L
    from repro_torch.train.steps import make_serve_step

    counters = [getattr(ops, n) for n in KERNEL_COUNTERS]

    def zero():
        zero_counts(counters)

    def read():
        return read_counts(counters)

    R, budget = ENCDEC_ROWS, ENCDEC_BUDGET
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = encdec.init(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    frames = ar1_frames(torch, gen, R, cfg.n_frame_tokens, cfg.d_model,
                        dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    weights_gib = sum(x.numel() * x.element_size()
                      for x in flatten(params)) / 2**30
    print(f"encoder-decoder: {cfg.arch_id} full width, {cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, bf16 weights from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s, {weights_gib:.2f} GiB",
          flush=True)
    rng = np.random.default_rng(19)
    plen = rng.integers(ENCDEC_PROMPTS[0], ENCDEC_PROMPTS[1] + 1, R)
    prompts = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (R, ENCDEC_PROMPTS[1]))).to(dev, torch.int32)
    T = plen + budget - 1            # the steps row b takes
    n_steps = int(T.max())
    at = np.arange(n_steps)[:, None]
    active = torch.from_numpy(at < T[None]).to(dev)
    prompted = torch.from_numpy(at < plen[None]).to(dev)
    serve = make_serve_step(cfg)
    cache = encdec.init_cache(cfg, R, ENCDEC_CACHE, device=dev)
    fed = torch.empty((n_steps, R), dtype=torch.int32, device=dev)
    cls = torch.empty_like(fed)
    out = torch.empty_like(fed)

    # warm up (first launches, the BLAS library's plans) on a scratch cache
    with torch.no_grad():
        warm = encdec.encode(params, cfg, frames)
    serve(params, encdec.init_cache(cfg, R, ENCDEC_CACHE, device=dev),
          prompts[:, :1], torch.zeros(R, dtype=torch.int32, device=dev), warm)
    del warm
    # the counted run: encode once, then every step
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        enc_out = encdec.encode(params, cfg, frames)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = prompts[:, 0]
    cl = torch.zeros(R, dtype=torch.int32, device=dev)
    nxt = tok
    for t in range(n_steps):
        if t:
            new = torch.where(prompted[t], prompts[:, min(
                t, ENCDEC_PROMPTS[1] - 1)], nxt)
            tok = torch.where(active[t], new, tok)
            cl = torch.where(active[t], t, cl)
        fed[t], cls[t] = tok, cl
        nxt, cache = serve(params, cache, tok[:, None], cl, enc_out)
        out[t] = nxt
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read()
    expected = {"flash_attention_fwd": cfg.n_enc_layers,
                "decode_attention": 2 * cfg.n_layers * n_steps,
                "decode_attention_fused": cfg.n_layers * n_steps}
    for name, n in launches.items():
        check(n == expected.get(name, 0), f"{cfg.arch_id} serving: {name} "
              f"launched {n} times, expected {expected.get(name, 0)}")
    served = [out[plen[b] - 1:T[b], b].tolist() for b in range(R)]
    check(all(len(x) == budget for x in served), "a request missed its "
          "budget")
    encode_ms, loop_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1)
    res = {"rows": R, "frames": cfg.n_frame_tokens,
           "prompt_tokens": plen.tolist(), "budget": budget,
           "steps": n_steps, "cache_len_end": cl.tolist(),
           "encode_wall_ms": encode_ms, "decode_wall_ms": loop_ms,
           "tokens_per_s": R * budget / ((t2 - t0)),
           "decode_tokens_per_s": R * budget / (t2 - t1),
           "launches": launches,
           "launches_per_step": {n: launches[n] / n_steps for n in (
               "decode_attention", "decode_attention_fused",
               "update_kv_buffer")}}

    # one step and one encode alone: host clock against device busy
    def one_step():
        serve(params, cache, tok[:, None], cl, enc_out)

    def one_encode():
        with torch.no_grad():
            encdec.encode(params, cfg, frames)
    res["step_host_ms"] = host_ms(torch, one_step, reps=10)
    res["step_device_busy_ms"] = device_busy_ms(torch, one_step, top=6)
    res["step_device_ops"] = device_busy_ms.ops
    res["encode_host_ms"] = host_ms(torch, one_encode, reps=3)
    res["encode_device_busy_ms"] = device_busy_ms(torch, one_encode, top=6)
    busy = {k: "not measured" if res[k] is None else f"{res[k]:.3f}"
            for k in ("step_device_busy_ms", "encode_device_busy_ms")}
    print(f"encdec serving: {R} requests x {cfg.n_frame_tokens} frames, "
          f"prompts {plen.tolist()}, budgets {budget}: {n_steps} steps, "
          f"tokens/s={res['tokens_per_s']:.1f} (decode alone "
          f"{res['decode_tokens_per_s']:.1f}); encode wall {encode_ms:.1f} "
          f"ms, alone {res['encode_host_ms']:.3f} ms host vs "
          f"{busy['encode_device_busy_ms']} device busy; decode step "
          f"{loop_ms / n_steps:.3f} ms in the loop, alone "
          f"{res['step_host_ms']:.3f} ms host vs "
          f"{busy['step_device_busy_ms']} device busy; launches per step "
          f"{res['launches_per_step']}, encode {launches}", flush=True)

    # the served tokens against a teacher-forced replay's logits
    replay = encdec.init_cache(cfg, R, ENCDEC_CACHE, device=dev)
    dec = torch.empty((R, n_steps, cfg.padded_vocab), dtype=torch.float32,
                      device=dev)
    with torch.no_grad():
        for t in range(n_steps):
            lg, replay = encdec.forward(params, cfg, fed[t][:, None],
                                        cache=replay, cache_len=cls[t],
                                        enc_out=enc_out)
            dec[:, t] = lg[:, 0]
    check(torch.equal(dec.argmax(-1).to(torch.int32), out.T),
          "the served tokens differ from a replay's argmax")
    del replay
    # decode equals prefill: the no-cache forward over the same tokens
    # (row b's first T[b] positions; the rest are a finished row's repeats)
    valid = torch.from_numpy(np.arange(n_steps)[None] < T[:, None]).to(dev)
    zero()
    with torch.no_grad():
        pre, _ = encdec.forward(params, cfg, fed.T.contiguous(),
                                frames=frames)
    nocache_launches = read()
    check(nocache_launches["flash_attention_fwd"]
          == cfg.n_enc_layers + 2 * cfg.n_layers
          and sum(nocache_launches.values())
          == nocache_launches["flash_attention_fwd"],
          f"no-cache forward launches {nocache_launches}")
    d_pre = (pre - dec).abs()[valid].max().item()
    agree = (pre.argmax(-1) == dec.argmax(-1))[valid].float().mean().item()
    del dec
    print(f"encdec decode vs prefill (bf16, {int(valid.sum())} positions): "
          f"max_abs_diff={d_pre:.4f} (tol {LOGITS_ATOL_BF16}) "
          f"logit_absmax={pre.abs().max().item():.3f} argmax_agree="
          f"{agree:.4f}; no-cache launches {nocache_launches}", flush=True)
    check(bool(torch.isfinite(pre).all()), "non-finite prefill logits")
    check(d_pre <= LOGITS_ATOL_BF16, f"decode differs from prefill by "
          f"{d_pre}")
    res.update(decode_vs_prefill_max_abs_diff=d_pre,
               decode_vs_prefill_argmax_agree=agree,
               nocache_launches=nocache_launches)

    # the no-cache forward, kernels vs plain
    with torch.no_grad():
        pre_plain, _ = encdec.forward(
            params, cfg, fed.T.contiguous(), frames=frames,
            kernels=ops.Kernels(attend=L.flash_attention_xla))
    d_nc = (pre - pre_plain).abs().max().item()
    del pre, pre_plain
    torch.cuda.empty_cache()
    # one decode step from the served state (ragged cache lengths), kernels
    # vs plain, and the control

    def step_logits(kernels):
        c = {n: x.clone() for n, x in cache.items()}
        with torch.no_grad():
            lg, _ = encdec.forward(params, cfg, tok[:, None], cache=c,
                                   cache_len=cl, enc_out=enc_out,
                                   kernels=kernels)
        return lg[:, 0]
    lk = step_logits(ops.KERNELS)
    lp = step_logits(ops.Kernels(attend=ops.decode_attention_plain))
    lc = step_logits(ops.Kernels(attend=cut_cross))
    d_step = (lk - lp).abs().max().item()
    d_ctrl = (lc - lp).abs().max().item()
    print(f"encdec kernels vs plain (bf16): no-cache forward max_abs_diff="
          f"{d_nc:.4f}, decode step (cache lens {cl.tolist()}) "
          f"max_abs_diff={d_step:.4f} (tol {LOGITS_ATOL_BF16}); control "
          f"(cross-attention cut to {ENCDEC_CUT_LENS} of "
          f"{cfg.n_frame_tokens} positions) {d_ctrl:.4f}", flush=True)
    check(d_nc <= LOGITS_ATOL_BF16, f"no-cache logits, kernels vs plain, "
          f"differ by {d_nc}")
    check(d_step <= LOGITS_ATOL_BF16, f"decode logits, kernels vs plain, "
          f"differ by {d_step}")
    check(d_ctrl > LOGITS_ATOL_BF16, f"the control passes the decode "
          f"check: {d_ctrl}")
    res.update(nocache_kernel_vs_plain_max_abs_diff=d_nc,
               step_kernel_vs_plain_max_abs_diff=d_step,
               control_max_abs_diff=d_ctrl)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, cache, enc_out, lk, lp, lc
    gc.collect()
    torch.cuda.empty_cache()

    # 2 + 2 layers in f32: greedy decode against prefill
    cfg32 = dataclasses.replace(cfg, n_layers=2, n_enc_layers=2,
                                params_dtype="float32",
                                compute_dtype="float32",
                                kv_cache_dtype="float32")
    p32 = encdec.init(cfg32, seed=2, device=dev)
    with torch.no_grad():
        enc32 = encdec.encode(p32, cfg32, frames.float())
        c32 = encdec.init_cache(cfg32, R, ENCDEC_CACHE, device=dev)
        dec32 = []
        for t in range(n_steps):
            lg, c32 = encdec.forward(p32, cfg32, fed[t][:, None], cache=c32,
                                     cache_len=cls[t], enc_out=enc32)
            dec32.append(lg[:, 0].argmax(-1))
        pre32, _ = encdec.forward(p32, cfg32, fed.T.contiguous(),
                                  frames=frames.float())
    top2 = pre32.topk(2, dim=-1).values
    decided = valid & ((top2[..., 0] - top2[..., 1]) > MARGIN_F32)
    same = pre32.argmax(-1) == torch.stack(dec32, dim=1)
    print(f"encdec f32 (2 + 2 layers) greedy decode vs prefill: "
          f"{int((same & valid).sum())}/{int(valid.sum())} equal, "
          f"decided {int(decided.sum())}", flush=True)
    check(bool(same[decided].all()), "f32 greedy decode differs from "
          "prefill at a position whose top-2 margin exceeds 1e-3")
    res["f32_greedy_equal"] = [int((same & valid).sum()),
                               int(valid.sum()), int(decided.sum())]
    del p32, enc32, c32, pre32
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --------------------------- phase 20: the multi-device and planning tools --

def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def remat_modes_phase(torch, cfg, dev) -> dict:
    """Phase 20a: one train step of ``cfg`` at DOTS_LAYERS layers of full
    width (phase 7's batch: 2 x 4096 tokens in 2 microbatches, bf16
    compute with the kernels, f32 master weights from one seed) under
    remat "none", "full" and "dots", and under "dots" with a policy that
    keeps nothing (the control). Each step's peak is read above the
    memory held when it starts. Returns the readings, with the dots
    step's gradients (``"grads"``) for phase 20c."""
    import numpy as np
    from torch.utils import checkpoint as ckpt

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.models import module
    from repro_torch.models.registry import get_api
    from repro_torch.train.steps import make_train_step

    def keep_nothing(ctx, op, *args, **kwargs):
        return ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    tcfg = dataclasses.replace(cfg, n_layers=DOTS_LAYERS)
    check(tcfg.params_dtype == "float32" and tcfg.compute_dtype ==
          "bfloat16", f"{cfg.arch_id}'s training dtypes changed")
    base = get_api(tcfg).init(tcfg, seed=3, device=dev, master=True)
    names = leaf_paths(base)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 500, size=(TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    tc = TrainConfig(microbatches=TRAIN_MICRO)
    counters = [getattr(ops, n) for n in KERNEL_COUNTERS]
    per_layer = 4 + (3 if cfg.mlp_kind == "swiglu" else 2)
    runs = {}
    for label, remat, kernels in (
            ("none", "none", ops.KERNELS), ("full", "full", ops.KERNELS),
            ("dots", "dots", ops.KERNELS),
            ("control", "dots", ops.Kernels(dots_policy=keep_nothing))):
        step, opt = make_train_step(dataclasses.replace(tcfg, remat=remat),
                                    tc, kernels)
        params = _clone_tree(base)
        state = opt.init(params)
        gc.collect()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        module.save_products.saved = 0
        _, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - start
        launches = {f.__name__: f.launches for f in counters}
        saved = module.save_products.saved
        gnorm = float(metrics["grad_norm"])
        scale = (1 - tc.beta1) * min(1.0, tc.grad_clip / max(gnorm, 1e-9))
        grads = [m.clone().div_(scale) for m in flatten(state.m)]
        # a second step, timed: the first one's time has the allocator's
        # growth in it
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        runs[label] = {
            "loss": float(metrics["loss"]), "grad_norm": gnorm,
            "grads": grads, "step_ms": 1e3 * (time.perf_counter() - t0),
            "peak_gb": peak / 1e9, "saved_products": saved,
            "launches": launches}
        del params, state, step, opt, grads
    del base

    def against(got, ref):
        rels = [(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30)).item()
                for a, b in zip(got["grads"], ref["grads"])]
        rel = max(rels)
        return {"loss_abs_diff": abs(got["loss"] - ref["loss"]),
                "grad_leaf_max_rel_norm_diff": rel,
                "grad_leaf_max": names[rels.index(rel)],
                "bit_equal": got["loss"] == ref["loss"] and all(
                    torch.equal(a, b)
                    for a, b in zip(got["grads"], ref["grads"]))}

    L_, mb = DOTS_LAYERS, TRAIN_MICRO
    expected = {"none": (L_ * mb, 0), "full": (2 * L_ * mb, 0),
                "dots": (2 * L_ * mb, per_layer * L_ * mb),
                "control": (2 * L_ * mb, per_layer * L_ * mb)}
    out = {"layers": L_, "weight_products_per_layer": per_layer}
    for label, r in runs.items():
        fwd, saved = expected[label]
        out[label] = {k: v for k, v in r.items() if k != "grads"}
        out[label]["launches_ok"] = (
            r["launches"]["flash_attention_fwd"] == fwd
            and r["launches"]["flash_attention_bwd"] == L_ * mb
            and sum(r["launches"].values()) == fwd + L_ * mb)
        out[label]["saved_ok"] = r["saved_products"] == saved
        print(f"remat {label} ({cfg.arch_id}, {L_} layers full width, bf16 "
              f"with the kernels, {TRAIN_BATCH}x{TRAIN_SEQ} in {mb} "
              f"microbatches): loss {r['loss']:.6f} grad_norm "
              f"{r['grad_norm']:.6f} step_ms (second step) "
              f"{r['step_ms']:.1f} peak "
              f"{r['peak_gb']:.3f} GB above the step's start, products kept "
              f"{r['saved_products']} (dots keeps {per_layer} a layer and "
              f"microbatch: {saved}), launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }",
              flush=True)
    for ref in ("none", "full"):
        cmp = against(runs["dots"], runs[ref])
        out[f"dots_vs_{ref}"] = cmp
        print(f"remat dots vs {ref}: |loss diff| {cmp['loss_abs_diff']:.3e} "
              f"(tol {STEP_LOSS_ATOL['bfloat16']}) grad leaves max relative "
              f"norm diff {cmp['grad_leaf_max_rel_norm_diff']:.3e} at "
              f"{cmp['grad_leaf_max']} (tol {STEP_GRAD_REL['bfloat16']}); "
              f"bit-equal: {cmp['bit_equal']}", flush=True)
        check(cmp["loss_abs_diff"] <= STEP_LOSS_ATOL["bfloat16"]
              and cmp["grad_leaf_max_rel_norm_diff"]
              <= STEP_GRAD_REL["bfloat16"], f"dots vs {ref}: {cmp}")
    for label in ("none", "full", "dots"):
        check(out[label]["launches_ok"], f"remat {label}: launches "
              f"{runs[label]['launches']}, expected K3a {expected[label][0]}"
              f" and K3b {L_ * mb}")
        check(out[label]["saved_ok"], f"remat {label}: kept "
              f"{runs[label]['saved_products']} products, expected "
              f"{expected[label][1]}")
    pk = {k: runs[k]["peak_gb"] for k in runs}
    check(pk["none"] > pk["dots"] > pk["full"], f"peak memory not ordered "
          f"none > dots > full: {pk}")
    # the control must fail: it keeps nothing, as "full" does, and its
    # peak is full's
    ctrl_like_full = (runs["control"]["saved_products"] == 0 and abs(
        pk["control"] - pk["full"]) <= DOTS_CONTROL_PEAK_REL * pk["full"])
    out["control_fails"] = ctrl_like_full and not out["control"]["saved_ok"]
    print(f"remat control (a policy that keeps nothing): products kept "
          f"{runs['control']['saved_products']}, peak {pk['control']:.3f} GB "
          f"against full's {pk['full']:.3f}; fails the dots check: "
          f"{out['control_fails']}", flush=True)
    check(out["control_fails"], f"the remat control passed the dots check "
          f"or differs from full: {out['control']}")
    out["grads"] = runs["dots"]["grads"]
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


DRYRUN_CELLS = (("seamless-m4t-medium", "decode_32k", True),
                ("starcoder2-7b", "decode_32k", False))


def dryrun_phase() -> dict:
    """Phase 20b: the port's dry run of DRYRUN_CELLS in a subprocess that
    sees no card (its fake world of 256 or 512 ranks stays out of this
    process): status, H100 roofline terms, peak GiB per device and the
    collectives by op."""
    code = ("import json, sys\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            f"cells = {DRYRUN_CELLS!r}\n"
            "out = [run_cell(*c) for c in cells]\n"
            "print('DRYRUN ' + json.dumps(out), flush=True)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("DRYRUN ")]
    check(r.returncode == 0 and bool(line), f"the dry run failed (rc "
          f"{r.returncode}): {r.stdout[-1500:]} {r.stderr[-3000:]}")
    cells = json.loads(line[0][len("DRYRUN "):])
    for c in cells:
        rl, mem = c["roofline"], c["memory"]
        check(c["status"] == "ok" and rl["bottleneck"] in (
            "compute", "memory", "collective"), f"dry-run cell {c}")
        print(f"dry run {c['arch']} {c['shape']} on {c['mesh']} ({c['chips']} "
              f"fake ranks, traced in {c['lower_s']} s): H100 roofline "
              f"compute {rl['compute_s'] * 1e3:.3f} ms, memory "
              f"{rl['memory_s'] * 1e3:.3f} ms, collective "
              f"{rl['collective_s'] * 1e3:.3f} ms -> {rl['bottleneck']}; "
              f"peak {mem['peak_bytes_dev'] / 2**30:.3f} GiB a device "
              f"(arguments {mem['argument_bytes_dev'] / 2**30:.3f}); "
              f"collectives {c['collectives']['by_op']}", flush=True)
    return {"cells": cells, "wall_s": wall}


def host_mesh_phase(torch, cfg, dev, grads) -> dict:
    """Phase 20c: a real mesh over the card (NCCL, world 1):
    ``rules_for`` of every arch on it, a starcoder2-7b decode step with
    and without the rules, int8_ef of phase 20a's gradients on the card
    against the CPU's, and a compressed all-reduce over the group."""
    import torch.distributed as dist

    from repro_torch.configs import all_arch_ids, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_api
    from repro_torch.optim.compression import (
        all_reduce_tree, compress_tree, decompress_tree,
    )
    from repro_torch.sharding import rules_for, tree_shardings
    from repro_torch.train.steps import make_serve_step

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    out = {}
    try:
        mesh = make_host_mesh()
        replicated = 0
        for arch in all_arch_ids():
            acfg = get_config(arch)
            api = get_api(acfg)
            rules = rules_for(acfg, mesh)
            check(rules.kv_rep == 1, f"{arch}: kv_rep {rules.kv_rep} on one "
                  f"device")
            sh = tree_shardings(mesh, rules, api.param_axes(acfg),
                                api.init(acfg, device="meta"),
                                fsdp_axes=("data",))
            for path in leaf_paths(sh):
                leaf = sh
                for k in path.strip("/").split("/"):
                    leaf = leaf[k]
                check(all(p.is_replicate() for p in leaf.placements),
                      f"{arch} {path}: {leaf.placements} on one device")
                replicated += 1
        out["replicated_leaves"] = replicated
        print(f"host mesh: {mesh} over nccl (world 1); rules_for of "
              f"{len(all_arch_ids())} archs: kv_rep 1 and {replicated} "
              f"parameter leaves, each replicated", flush=True)

        params = transformer.init(cfg, seed=0, device=dev)
        rules = rules_for(cfg, mesh)
        toks = {}
        for label, r in (("plain", None), ("rules", rules)):
            serve = make_serve_step(cfg, rules=r)
            cache = transformer.init_cache(cfg, 4, 64, device=dev)
            cur = torch.tensor([[11], [22], [33], [44]], device=dev)
            seq = []
            for t in range(HOST_MESH_STEPS):
                cl = torch.full((4,), t, dtype=torch.int32, device=dev)
                nxt, cache = serve(params, cache, cur, cl)
                seq.append(nxt.tolist())
                cur = nxt[:, None].long()
            toks[label] = seq
        del params, cache
        torch.cuda.empty_cache()
        out["decode_tokens_equal"] = toks["plain"] == toks["rules"]
        print(f"host mesh: {cfg.arch_id} ({cfg.n_layers} layers) "
              f"{HOST_MESH_STEPS} greedy decode steps with the rules "
              f"(one device) equal without: {out['decode_tokens_equal']}",
              flush=True)
        check(out["decode_tokens_equal"], f"decode with rules differs: "
              f"{toks}")

        tree = {f"{i:03d}": g for i, g in enumerate(grads)}
        n = sum(g.numel() for g in grads)
        compress_tree(tree, "int8_ef")            # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload, err = compress_tree(tree, "int8_ef")
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        cpu_tree = {k: v.cpu() for k, v in tree.items()}
        t0 = time.perf_counter()
        cpu_payload, cpu_err = compress_tree(cpu_tree, "int8_ef")
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        equal = all(
            torch.equal(payload[k][0].cpu(), cpu_payload[k][0])
            and torch.equal(payload[k][1].cpu(), cpu_payload[k][1])
            and torch.equal(err[k].cpu(), cpu_err[k]) for k in tree)
        out.update(int8_ef_elements=n, int8_ef_card_ms=card_ms,
                   int8_ef_cpu_ms=cpu_ms, int8_ef_bit_equal=equal)
        print(f"int8_ef of phase 20a's gradients ({len(tree)} leaves, "
              f"{n / 1e9:.3f} G elements): card {card_ms:.1f} ms, CPU "
              f"{cpu_ms:.1f} ms; q, scales and carried error bit-equal: "
              f"{equal}", flush=True)
        check(equal, "int8_ef on the card differs from the CPU's")
        del cpu_tree, cpu_payload, cpu_err, payload, err

        small = {k: tree[k] for k in list(tree)[:4]}
        for method in ("bf16", "int8_ef"):
            summed, _ = all_reduce_tree(small, method)
            want = decompress_tree(compress_tree(small, method)[0], method)
            same = all(torch.equal(summed[k], want[k]) for k in small)
            out[f"all_reduce_{method}_equal"] = same
            print(f"compressed all_reduce ({method}) over the nccl group of "
                  f"one: the dequantised tree: {same}", flush=True)
            check(same, f"compressed all_reduce ({method}) differs")
    finally:
        dist.destroy_process_group()
    return out


# ------------------------- phase 21: the examples and launchers on the card --

LAUNCHER_TIMEOUT_S = 300
# the training launcher's steps and learning rate under torchrun (its
# loss must fall: reduced rwkv6-3b's moves little in 6 steps at 1e-3)
LAUNCHER_STEPS = 12
LAUNCHER_LR = "3e-3"
# the models phase 21 trains under torchrun, and the kernels each must
# launch there (the attention's; the hybrid's and the SSM's scans)
TORCHRUN_KERNELS = {
    "internlm2-20b": ("flash_attention_fwd", "flash_attention_bwd"),
    "zamba2-2.7b": ("flash_attention_fwd", "flash_attention_bwd",
                    "mamba2_ssd_fwd", "mamba2_ssd_bwd"),
    "rwkv6-3b": ("rwkv6_wkv_fwd", "rwkv6_wkv_bwd"),
    "moonshot-v1-16b-a3b": ("flash_attention_fwd", "flash_attention_bwd",
                            "gmm_fwd", "gmm_bwd")}


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not yet run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_launcher(args, *, prompt=None, timeout_s: float = LAUNCHER_TIMEOUT_S
                 ) -> tuple[int, str, list]:
    """Run ``args`` (after ``python``) from the repository's root with
    ``src`` on the path; with ``prompt``, send it as an int32 datagram
    every 100 ms to the port given as ``--port``'s value until a reply
    comes back on the socket whose port replaces ``{reply}`` in ``args``
    (the continuous server stops at its first idle stretch with nothing
    in flight, ~0.2 s of polls, so a prompt has to land soon after it
    binds its port).
    Returns (exit code, output, replies). The process is killed if it
    outlives ``timeout_s``."""
    import numpy as np

    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.bind(("127.0.0.1", 0))
    client.settimeout(0.1)
    args = [a.format(reply=client.getsockname()[1]) for a in args]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    replies = []
    with tempfile.TemporaryFile("w+") as log:
        proc = subprocess.Popen([sys.executable] + args, cwd=ROOT, env=env,
                                stdout=log, stderr=subprocess.STDOUT,
                                text=True)
        try:
            end = time.monotonic() + timeout_s
            if prompt is not None:
                port = int(args[args.index("--port") + 1])
                data = np.asarray(prompt, np.int32).tobytes()
                while not replies and time.monotonic() < end \
                        and proc.poll() is None:
                    client.sendto(data, ("127.0.0.1", port))
                    try:
                        reply, _ = client.recvfrom(65536)
                        replies.append(np.frombuffer(reply,
                                                     np.int32).tolist())
                    except socket.timeout:
                        pass
            rc = proc.wait(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            client.close()
        log.seek(0)
        out = log.read()
    return rc, out, replies


def timed_launcher(args, prompt):
    """:func:`run_launcher` and its wall seconds."""
    t0 = time.perf_counter()
    return (*run_launcher(args, prompt=prompt), time.perf_counter() - t0)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def examples_phase(torch) -> dict:
    """Phase 21: the port's three examples in this process through their
    ``main`` on the card (K3a/K3b's launches counted over train_lm, which
    trains on the reduced configs' head dim 32), then ``torchrun`` of the
    training launcher (data-parallel worlds of one, TORCHRUN_KERNELS'
    models) and the serving launcher, dense and continuous, in
    subprocesses. Each must finish and give what its docstring promises."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    out = {}
    t0 = time.perf_counter()
    hints = load_example("torch_memory_hints").main([])
    check(len(hints["rss_mb"]) == 3 and len(hints["released_rss_mb"]) == 2
          and all(r < p for r, p in zip(hints["released_rss_mb"],
                                        hints["rss_mb"][1:])),
          f"torch_memory_hints: RSS {hints}")
    out["memory_hints"] = dict(hints, s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    echo_mod = load_example("torch_serve_echo")
    echo = echo_mod.main([])
    vocab = get_config("rwkv6-3b").reduced().vocab_size
    check(len(echo) == echo_mod.MAX_TOKENS
          and all(0 <= t < vocab for t in echo),
          f"torch_serve_echo: continuation {echo}")
    out["serve_echo"] = {"tokens": echo, "s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    counters = (ops.flash_attention_fwd, ops.flash_attention_bwd)
    steps = 20
    zero_counts(counters)
    lm_mod = load_example("torch_train_lm")
    lm = lm_mod.main(["--steps", str(steps)])
    launches = read_counts(counters)
    rcfg = get_config("internlm2-20b").reduced()
    want = rcfg.n_layers * (steps + lm_mod.RESUME_STEPS)  # remat "none"
    losses = lm["stats"].losses + lm["resume_losses"]
    print(f"torch_train_lm ({rcfg.arch_id} reduced, hd {rcfg.hd}): "
          f"{steps} steps, loss {losses[0]:.4f} -> "
          f"{lm['stats'].losses[-1]:.4f}, {lm['stats'].ckpts} checkpoints, "
          f"resumed at {lm['resumed_at']} (committed {lm['committed']}); "
          f"K3 launches {launches} (expected {want} each)", flush=True)
    check(all(math.isfinite(x) for x in losses), f"train_lm losses {losses}")
    check(lm["stats"].losses[-1] < lm["stats"].losses[0],
          f"train_lm: the loss did not fall over {steps} steps: "
          f"{lm['stats'].losses}")
    check(lm["resumed_at"] == lm["committed"] == steps,
          f"train_lm resumed at {lm['resumed_at']}, committed "
          f"{lm['committed']}")
    check(all(n == want for n in launches.values()),
          f"train_lm: K3 launched {launches}, expected {want} each")
    check(all(lm["syscalls"].get(n, 0) > 0
              for n in ("PREAD64", "PWRITE64", "MADVISE")),
          f"train_lm syscalls {lm['syscalls']}")
    out["train_lm"] = {"losses": losses, "ckpts": lm["stats"].ckpts,
                       "resumed_at": lm["resumed_at"], "launches": launches,
                       "s": time.perf_counter() - t0}

    # the training launcher under torchrun for a dense, a hybrid, an SSM
    # and an MoE model: the attention's, the scans' and the experts'
    # kernels on the rank's rows
    runs = {f"torchrun_{arch}": (
        ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", "-m", "repro_torch.launch.train", "--arch", arch, "--reduced",
         "--steps", str(LAUNCHER_STEPS), "--lr", LAUNCHER_LR],
        None, (f"[rank 0/1] steps={LAUNCHER_STEPS}", "[rank 0/1] GENESYS: ",
               "[rank 0/1] kernel launches: "))
        for arch in TORCHRUN_KERNELS}
    runs.update({
        "serve_dense": (
            ["-m", "repro_torch.launch.serve", "--arch", "starcoder2-7b",
             "--reduced", "--port", str(free_port()), "--reply-port",
             "{reply}", "--batches", "1"],
            [1, 5, 9], ("requests=", " batches=1 ")),
        "serve_continuous": (
            ["-m", "repro_torch.launch.serve", "--arch", "starcoder2-7b",
             "--reduced", "--port", str(free_port()), "--reply-port",
             "{reply}", "--continuous"],
            [1, 5, 9], ("engine: occupancy=", "requests=")),
    })
    # the processes at once (each mostly starts up: Python, torch, the
    # card; three one after another took 66 s of the smoke's budget)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        futures = {name: pool.submit(timed_launcher, args, prompt)
                   for name, (args, prompt, _) in runs.items()}
    out["launchers_s"] = time.perf_counter() - t0
    for name, (args, prompt, promised) in runs.items():
        rc, text, replies, s = futures[name].result()
        tail = "\n".join(text.strip().splitlines()[-6:])
        print(f"{name}: rc={rc} in {s:.1f} s, replies {replies}; last "
              f"lines:\n{tail}", flush=True)
        check(rc == 0, f"{name}: exit code {rc}:\n{text[-3000:]}")
        for line in promised:
            check(line in text, f"{name}: no {line!r} in its output")
        out[name] = {"rc": rc, "replies": replies, "s": s}
        if name.startswith("torchrun_"):
            first, last = (float(x) for x in re.search(
                r"loss\[0\]=(\S+) loss\[-1\]=(\S+)", text).groups())
            check(last < first, f"{name}: the loss did not fall: {first} -> "
                  f"{last}")
            launches = ast.literal_eval(re.search(
                r"kernel launches: (\{.*?\})", text).group(1))
            check(all(launches[k] > 0
                      for k in TORCHRUN_KERNELS[name[len("torchrun_"):]]),
                  f"{name}: a kernel of its path was not launched: "
                  f"{launches}")
            out[name].update(losses=[first, last], launches=launches)
        if prompt is not None:
            check(len(replies) >= 1 and len(replies[0]) == 8,
                  f"{name}: replies {replies}")
    return out


# ------------------------------------------------------------------ main --

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs a GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside this script "
              f"({SRC / 'repro_torch'}); run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        return run(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


def run(torch) -> int:
    t_start = time.perf_counter()
    phase_end_s = {}

    def mark(phase: str) -> None:       # wall time since the start
        phase_end_s[phase] = time.perf_counter() - t_start
        print(f"[{phase_end_s[phase]:.1f} s] phase {phase} done", flush=True)

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import mamba2_scan as ms
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rwkv6_scan as wr
    from repro_torch.models import layers as L
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    # the invoke kernel with its %globaltimer stamps (phase 18 reads one
    # call of each round trip through it), built beside the path's library
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        stamped = pool.submit(stamped_invoke_build)
        lib = _build.build()
        stamped_lib = stamped.result()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = [ln.split("info    : ")[-1] for ln in
            (lib.parent / "ptxas.log").read_text().splitlines()
            if "registers" in ln]
    print(f"kernel build: {build_s:.1f} s ({lib.name}); ptxas: "
          f"{'; '.join(regs)}", flush=True)

    # phase 2: each kernel against its plain version at the path's shapes
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    mcfg = get_config("moonshot-v1-16b-a3b")
    moe_heads = (mcfg.n_heads, mcfg.n_kv_heads, mcfg.hd)
    decode_cases, paged_fused, append = kernel_phase(torch, dev, flush,
                                                     moe_heads)
    mark("2")
    # phase 2b: the dense kernel against its plain version
    zcfg = get_config("zamba2-2.7b")
    scfg = get_config("seamless-m4t-medium")
    dense_cases, dense_fused, hybrid_appends = dense_kernel_phase(
        torch, dev, flush, (zcfg.n_heads, zcfg.n_kv_heads, zcfg.hd),
        moe_heads, (scfg.n_heads, scfg.n_kv_heads, scfg.hd))
    mark("2b")
    # phase 22, early: the cells' optimizer state takes ~74 GB of the card
    torch.cuda.empty_cache()
    adamw_cases = adamw_kernel_phase(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()
    mark("22")

    # phase 3: the main path at full width
    cfg = get_config("starcoder2-7b")
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    print(f"main path: starcoder2-7b full width, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, bf16 weights from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    sc_main = main_path_run(torch, cfg, params, n_blocks=N_BLOCKS, per_layer={
        ops.paged_decode_attention: 1, ops.update_kv_buffer: 0})
    mark("3")

    # phase 4a: one step's logits, kernels vs plain, full width bf16
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = paged_state(torch, cfg, dev, gen, n_blocks=N_BLOCKS,
                        max_len=1024)
    lk, lp = logits_kernel_vs_plain(torch, cfg, params, state)
    d_bf16 = (lk - lp).abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    print(f"logits bf16 full width (32 layers): max_abs_diff={d_bf16:.4f} "
          f"(tol {LOGITS_ATOL_BF16}) logit_absmax={lp.abs().max().item():.3f}"
          f" argmax_agree={agree:.3f} finite={bool(torch.isfinite(lk).all())}",
          flush=True)
    check(bool(torch.isfinite(lk).all()), "non-finite logits")
    check(d_bf16 <= LOGITS_ATOL_BF16, f"bf16 logits differ by {d_bf16}")
    # the same kernel step alone, the host plane's threads stopped
    arenas, bt, cl, tok = state

    def one_step():
        with torch.no_grad():
            transformer.forward(params, cfg, tok, cache_len=cl,
                                paged_cache=(arenas["k"], arenas["v"], bt))
    alone_ms = host_ms(torch, one_step, reps=10)
    busy_ms = device_busy_ms(torch, one_step)
    step_ops = device_busy_ms.ops
    busy = "not measured" if busy_ms is None else f"{busy_ms:.3f}"
    print(f"step alone (8 rows, cached lens {cl.tolist()}): "
          f"host_ms={alone_ms:.3f} device_busy_ms={busy} "
          f"device_ops={step_ops} "
          f"(weights bound {weights_gb / HBM_BYTES_PER_S * 1e12:.3f} ms)",
          flush=True)
    del state, lk, lp
    torch.cuda.empty_cache()

    # phase 4b: two layers at full width in f32, greedy tokens
    cfg32 = dataclasses.replace(cfg, n_layers=2, params_dtype="float32",
                                compute_dtype="float32",
                                kv_cache_dtype="float32")
    params32 = transformer.init(cfg32, seed=2, device=dev)
    state = paged_state(torch, cfg32, dev, gen, n_blocks=1024, max_len=1024)
    lk, lp = logits_kernel_vs_plain(torch, cfg32, params32, state)
    top2 = lp.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > MARGIN_F32
    same = lk.argmax(-1) == lp.argmax(-1)
    d_f32 = (lk - lp).abs().max().item()
    print(f"logits f32 full width (2 layers): max_abs_diff={d_f32:.3e} "
          f"greedy_equal={int(same.sum())}/{B} decided_rows="
          f"{int(decided.sum())}", flush=True)
    check(bool(same[decided].all()), "f32 greedy tokens differ on a row "
          "whose top-2 margin exceeds 1e-3")
    del params32, state
    torch.cuda.empty_cache()
    mark("4")

    # phase 5: the dense path at full width, phase 3's weights
    dense_runs = dense_path_phase(torch, cfg, params)
    # phase 5b: one dense step's logits, kernels vs plain, full width bf16
    (lk, lp), dense_cl = dense_logits_kernel_vs_plain(torch, cfg, params,
                                                      dev, gen)
    d_dense = (lk - lp).abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    print(f"dense logits bf16 full width (32 layers, cached lens "
          f"{dense_cl}): max_abs_diff={d_dense:.4f} (tol "
          f"{LOGITS_ATOL_BF16}) logit_absmax={lp.abs().max().item():.3f} "
          f"argmax_agree={agree:.3f} "
          f"finite={bool(torch.isfinite(lk).all())}", flush=True)
    check(bool(torch.isfinite(lk).all()), "non-finite dense logits")
    check(d_dense <= LOGITS_ATOL_BF16, f"dense bf16 logits differ by "
          f"{d_dense}")
    del lk, lp
    mark("5")
    # phase 5c: Fig. 12's churn and spill workload, phase 3's weights
    fig12 = fig12_phase(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mark("5c")

    # phase 6: the flash-attention kernels against their plain versions
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flash_cases = flash_kernel_phase(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()
    mark("6")
    # phase 7: training at full width, 8 layers; 7b: kernels vs plain
    tcfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    per = TRAIN_MICRO * (TRAIN_STEPS + RESUME_STEPS)
    train = train_path_phase(torch, tcfg, dev, expected={
        "flash_attention_fwd": 2 * TRAIN_LAYERS * per,   # remat: twice
        "flash_attention_bwd": TRAIN_LAYERS * per})
    train["step_kernel_vs_plain"] = step_kernel_vs_plain(
        torch, cfg, dev, layers=2,
        plain=ops.Kernels(attend=L.flash_attention_xla),
        control=ops.Kernels(attend=dropped_tile),
        control_label=f"keys {CONTROL_KEYS[0]}-{CONTROL_KEYS[1] - 1} zeroed")
    mark("7")

    # the hybrid family: zamba2-2.7b at full width (served at all 54
    # layers, trained at 18)
    # phase 8: the SSD scan kernels against their plain versions
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ssd_cases = ssd_kernel_phase(torch, zcfg, dev, flush)
    del flush
    torch.cuda.empty_cache()
    mark("8")
    # phase 9: training, 3 of 9 groups; the mamba layers run twice under
    # remat, the shared block once
    ztcfg = dataclasses.replace(zcfg, n_layers=HYBRID_TRAIN_LAYERS)
    n_attn = attention_layers(ztcfg)
    ztrain = train_path_phase(torch, ztcfg, dev, expected={
        "mamba2_ssd_fwd": 2 * ztcfg.n_layers * per,
        "mamba2_ssd_bwd": ztcfg.n_layers * per,
        "flash_attention_fwd": n_attn * per,
        "flash_attention_bwd": n_attn * per})
    # phase 9b: one group (6 mamba layers and the shared block), kernels
    # vs plain, with the decay of Mamba2's initialisation
    ztrain["step_kernel_vs_plain"] = step_kernel_vs_plain(
        torch, zcfg, dev, layers=zcfg.shared_attn_period,
        plain=ops.Kernels(attend=L.flash_attention_xla,
                          ssd=ms.ssd_chunked_plain),
        control=ops.Kernels(attend=L.flash_attention_xla,
                            ssd=carry_dropped(ms.ssd_chunked_plain)),
        control_label="the SSD carry into chunk 32 dropped",
        prepare=lambda p, seed: set_mamba2_decay(torch, p, seed=seed),
        bf16_seeds=(21, 22, 23))
    mark("9")
    # phase 10: serving
    zserve = recurrent_serve_phase(
        torch, zcfg, dev, prefill_launches={
            "mamba2_ssd_fwd": zcfg.n_layers,
            "flash_attention_fwd": attention_layers(zcfg)},
        control=ops.Kernels(ssd=carry_dropped(ms.ssd_chunked_plain)))
    mark("10")

    # the SSM family: rwkv6-3b at full width (served at all 32 blocks,
    # trained at 8)
    # phase 11: the WKV kernels against their plain versions
    rcfg = get_config("rwkv6-3b")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    wkv_cases = wkv_kernel_phase(torch, rcfg, dev, flush)
    del flush
    torch.cuda.empty_cache()
    mark("11")
    # phase 12: training, 8 of 32 blocks; every block runs the WKV twice
    # under remat
    rtcfg = dataclasses.replace(rcfg, n_layers=SSM_TRAIN_LAYERS)
    rtrain = train_path_phase(torch, rtcfg, dev, expected={
        "rwkv6_wkv_fwd": 2 * rtcfg.n_layers * per,
        "rwkv6_wkv_bwd": rtcfg.n_layers * per})
    # phase 12b: two blocks, kernels vs plain, with RWKV-6's decay init
    rtrain["step_kernel_vs_plain"] = step_kernel_vs_plain(
        torch, rcfg, dev, layers=2,
        plain=ops.Kernels(wkv=wr.wkv6_chunked_plain),
        control=ops.Kernels(wkv=carry_dropped(wr.wkv6_chunked_plain)),
        control_label="the WKV carry into chunk 32 dropped",
        prepare=lambda p, seed: set_rwkv6_init(torch, p),
        bf16_seeds=WKV_STEP_SEEDS)
    mark("12")
    # phase 13: serving (no kernel: the decode recurrence is plain torch)
    rserve = recurrent_serve_phase(
        torch, rcfg, dev, prefill_launches={"rwkv6_wkv_fwd": rcfg.n_layers},
        control=ops.Kernels(wkv=carry_dropped(wr.wkv6_chunked_plain)),
        prepare=lambda p: set_rwkv6_init(torch, p))
    mark("13")

    # the MoE family: moonshot-v1-16b-a3b at full width
    # phase 14: the grouped-matmul kernels against their plain versions
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gmm_cases = gmm_kernel_phase(torch, mcfg, dev, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    mark("14")
    # phase 15: the main path, all 48 layers, over the paged engine
    mparams, mserve = moe_main_path_phase(torch, mcfg, dev)
    mark("15")
    # phase 16: the dense servers, and a bucket against its rows alone
    mserve["dense_path"] = dense_path_phase(torch, mcfg, mparams)
    mserve["bucket_vs_eager"] = moe_bucket_vs_eager(torch, mcfg, mparams,
                                                    dev)
    mark("16")
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    # phase 17: training, 2 of 48 layers (the one cut); 17b: kernels vs
    # plain on two layers
    mtcfg = dataclasses.replace(mcfg, n_layers=MOE_TRAIN_LAYERS)
    mtrain = train_path_phase(torch, mtcfg, dev, expected={
        "flash_attention_fwd": 2 * MOE_TRAIN_LAYERS * per,
        "flash_attention_bwd": MOE_TRAIN_LAYERS * per,
        "gmm_fwd": 3 * 2 * MOE_TRAIN_LAYERS * per,        # remat: twice
        "gmm_bwd": 3 * MOE_TRAIN_LAYERS * per})
    mark("17")
    mtrain["routing_flips"] = routing_flips(torch, mcfg, dev, layers=2)
    mtrain["step_kernel_vs_plain"] = step_kernel_vs_plain(
        torch, mcfg, dev, layers=2, plain=ops.Kernels(gmm=mg.gmm_plain),
        control=ops.Kernels(gmm=shifted_gmm),
        control_label="tile 1's expert id shifted in every expert product",
        pin_routing=True)
    mark("17b")
    # phase 23: Moonlight-16B-A3B, the benchmark's MoE cell: K6/K6b over a
    # dropless table, and one train step with its launches counted
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    moonlight = moonlight_phase(torch, dev, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    mark("23")
    # phase 18: device-initiated syscalls, Genesys.invoke on the card
    invoke = invoke_phase(torch, dev, stamped_lib)
    mark("18")

    # the encoder-decoder: seamless-m4t-medium at full width and depth
    # phase 19a: the decode step's cross-attention alone, then serving at
    # the step level
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    cross_case = cross_attention_case(torch, scfg, dev, flush)
    del flush
    eserve = encdec_serve_phase(torch, scfg, dev)
    mark("19a")
    # phase 19b: training, all 12 + 12 layers (remat runs every attention
    # forward twice); kernels vs plain on 2 + 2 layers
    n_attn = scfg.n_enc_layers + 2 * scfg.n_layers
    etrain = train_path_phase(torch, scfg, dev, expected={
        "flash_attention_fwd": 2 * n_attn * per,
        "flash_attention_bwd": n_attn * per},
        seq=ENCDEC_TEXT, frames=scfg.n_frame_tokens)
    for key, std in (("step_kernel_vs_plain", FRAME_STD),
                     ("step_kernel_vs_plain_alike_frames", 1.0)):
        etrain[key] = step_kernel_vs_plain(
            torch, scfg, dev, layers=2,
            plain=ops.Kernels(attend=L.flash_attention_xla),
            control=ops.Kernels(attend=dropped_tile),
            control_label=f"keys {CONTROL_KEYS[0]}-{CONTROL_KEYS[1] - 1} "
                          f"zeroed",
            seq=ENCDEC_TEXT, frames=scfg.n_frame_tokens, frame_std=std)
    mark("19")

    # phase 20: the multi-device and planning tools. 20a: remat "dots" at
    # full width (starcoder2-7b, 4 of 32 layers) against "none" and
    # "full", K3a/K3b recomputed under it
    tools = {"remat": remat_modes_phase(torch, cfg, dev)}
    mark("20a")
    # 20b: the dry run on the card's host, in a subprocess
    tools["dryrun"] = dryrun_phase()
    mark("20b")
    # 20c: a real mesh over the card (NCCL, world 1)
    tools["host_mesh"] = host_mesh_phase(torch, cfg, dev,
                                         tools["remat"].pop("grads"))
    mark("20")
    # phase 21: the examples and the launchers on the card
    examples = examples_phase(torch)
    mark("21")

    # the launches of the training launcher's torchrun runs (phase 21),
    # by run, of reduced models: K3 at hd 32, K4, K5 and K6/K6b
    torchruns = {f"{arch}-reduced-torchrun": examples[f"torchrun_{arch}"][
        "launches"] for arch in TORCHRUN_KERNELS}
    bf16 = decode_cases[0]
    kernels = [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/decode_attention.py:169",
         "launches": sc_main["launches"]["paged_decode_attention"]
         + mserve["launches"]["paged_decode_attention"]
         + fig12_launches(fig12, "paged_decode_attention"),
         "launches_by_run": {
             cfg.arch_id: sc_main["launches"]["paged_decode_attention"],
             mcfg.arch_id: mserve["launches"]["paged_decode_attention"],
             "fig12": fig12_launches(fig12, "paged_decode_attention")},
         "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"],
         "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
         "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
         "pass": True, "cases": decode_cases},
        # K1 as the paged step launches it: the step's token appended and
        # attended in one launch (every K1 launch of phases 3 and 15)
        {"name": "paged_decode_attention_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/decode_attention.py:169",
         "launches": sc_main["launches"]["paged_decode_attention_fused"]
         + mserve["launches"]["paged_decode_attention_fused"]
         + fig12_launches(fig12, "paged_decode_attention_fused"),
         "launches_by_run": {
             cfg.arch_id: sc_main["launches"]["paged_decode_attention_fused"],
             mcfg.arch_id:
                 mserve["launches"]["paged_decode_attention_fused"],
             "fig12": fig12_launches(fig12,
                                     "paged_decode_attention_fused")},
         "max_abs_err": paged_fused[0]["max_abs_err"],
         "ms": paged_fused[0]["ms"], "plain_ms": paged_fused[0]["plain_ms"],
         "bound_ms": paged_fused[0]["bound_ms"],
         "bound_by": paged_fused[0]["bound_by"], "library_ms": None,
         "two_call_ms": paged_fused[0]["two_call_ms"],
         "pass": True, "cases": paged_fused},
        {"name": "update_kv_buffer", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/ops.py:71",
         "launches": sc_main["launches"]["update_kv_buffer"]
         + mserve["launches"]["update_kv_buffer"]
         + eserve["launches"]["update_kv_buffer"],
         "launches_by_run": {
             cfg.arch_id: sc_main["launches"]["update_kv_buffer"],
             mcfg.arch_id: mserve["launches"]["update_kv_buffer"],
             f"{scfg.arch_id}-serve":
                 eserve["launches"]["update_kv_buffer"]},
         "max_abs_err": append["max_abs_err"], "ms": append["ms"],
         "plain_ms": append["plain_ms"], "bound_ms": append["bound_ms"],
         "bound_by": append["bound_by"], "library_ms": append["library_ms"],
         "pass": True, "cases": [append] + hybrid_appends,
         "note": "no serving path launches it: K1 and K2 append the "
                 "step's token (the _fused entries)"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dense_decode.cu",
         "replaces": "src/repro/kernels/decode_attention.py:83",
         "launches": sum(r["launches"] for runs in (
             dense_runs, zserve["dense_path"], mserve["dense_path"])
             for r in runs.values())
         + eserve["launches"]["decode_attention"]
         + fig12_launches(fig12, "decode_attention"),
         "launches_by_run": dict({f"{arch}-{m}": r["launches"]
                                  for arch, runs in (
                                      (cfg.arch_id, dense_runs),
                                      (zcfg.arch_id, zserve["dense_path"]),
                                      (mcfg.arch_id, mserve["dense_path"]))
                                  for m, r in runs.items()},
                                 **{f"{scfg.arch_id}-serve":
                                    eserve["launches"]["decode_attention"],
                                    "fig12": fig12_launches(
                                        fig12, "decode_attention")}),
         "max_abs_err": dense_cases[0]["max_abs_err"],
         "ms": dense_cases[0]["ms"], "plain_ms": dense_cases[0]["plain_ms"],
         "bound_ms": dense_cases[0]["bound_ms"],
         "bound_by": dense_cases[0]["bound_by"],
         "library_ms": dense_cases[0]["library_ms"],
         "pass": True, "cases": dense_cases + [cross_case]},
        # K2 as the dense steps launch it: attends the step's token and
        # appends it in one launch (every self-attention K2 launch of the
        # dense runs and of phase 19a)
        {"name": "decode_attention_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dense_decode.cu",
         "replaces": "src/repro/kernels/decode_attention.py:83",
         "launches": sum(r["fused_launches"] for runs in (
             dense_runs, zserve["dense_path"], mserve["dense_path"])
             for r in runs.values())
         + eserve["launches"]["decode_attention_fused"]
         + fig12_launches(fig12, "decode_attention_fused"),
         "launches_by_run": dict({f"{arch}-{m}": r["fused_launches"]
                                  for arch, runs in (
                                      (cfg.arch_id, dense_runs),
                                      (zcfg.arch_id, zserve["dense_path"]),
                                      (mcfg.arch_id, mserve["dense_path"]))
                                  for m, r in runs.items()},
                                 **{f"{scfg.arch_id}-serve": eserve[
                                     "launches"]["decode_attention_fused"],
                                    "fig12": fig12_launches(
                                        fig12, "decode_attention_fused")}),
         "max_abs_err": dense_fused[0]["max_abs_err"],
         "ms": dense_fused[0]["ms"], "plain_ms": dense_fused[0]["plain_ms"],
         "bound_ms": dense_fused[0]["bound_ms"],
         "bound_by": dense_fused[0]["bound_by"], "library_ms": None,
         "two_call_ms": dense_fused[0]["two_call_ms"],
         "pass": True, "cases": dense_fused},
    ]
    # the f32 steps of phases 7b, 9b, 17b and 19b: the f32 kernels' launches
    f32_steps = {cfg.arch_id: train["step_kernel_vs_plain"],
                 zcfg.arch_id: ztrain["step_kernel_vs_plain"],
                 mcfg.arch_id: mtrain["step_kernel_vs_plain"],
                 scfg.arch_id: etrain["step_kernel_vs_plain"],
                 f"{scfg.arch_id}-alike-frames":
                     etrain["step_kernel_vs_plain_alike_frames"]}
    for kind, name, line in (("fwd", "flash_attention_fwd", 76),
                             ("bwd", "flash_attention_bwd", 205)):
        case = flash_cases[kind][0]          # S=4096, bf16: the path's case
        f32_case = next(c for c in flash_cases[kind]
                        if c["case"] == "S4096-float32")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": train["launches"][name] + ztrain["launches"][name]
            + mtrain["launches"][name] + etrain["launches"][name]
            + moonlight["launches"][name] + eserve["launches"][name]
            + tools["remat"]["dots"]["launches"][name]
            + examples["train_lm"]["launches"][name]
            + sum(torchrun[name] for torchrun in torchruns.values()),
            "launches_by_run": {cfg.arch_id: train["launches"][name],
                                zcfg.arch_id: ztrain["launches"][name],
                                mcfg.arch_id: mtrain["launches"][name],
                                scfg.arch_id: etrain["launches"][name],
                                f"{moonlight['arch']}-step":
                                    moonlight["launches"][name],
                                f"{scfg.arch_id}-serve":
                                    eserve["launches"][name],
                                f"{cfg.arch_id}-remat-dots":
                                    tools["remat"]["dots"]["launches"][name],
                                "internlm2-20b-reduced-train_lm":
                                    examples["train_lm"]["launches"][name],
                                **{run: torchrun[name] for run, torchrun
                                   in torchruns.items()}},
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "f32_out_ms": case["f32_out_ms"],
            "bound_sfu_ms": case["bound_sfu_ms"],
            # the reduced configs' hd 32 (H 4 over KV 2): S 4096 and the
            # training example's 8 x 64, launched by train_lm on the path
            "hd32": {c["case"]: {n: c[n] for n in (
                "ms", "bound_ms", "bound_by", "bound_sfu_ms", "library_ms",
                "plain_ms", "max_abs_err")}
                for c in flash_cases[kind] if c["head_dim"] == 32
                and c["case"] in ("S4096-hd32-bfloat16",
                                  "B8-S64-hd32-bfloat16")},
            "hd32_launches": examples["train_lm"]["launches"][name]
            + sum(torchrun[name] for torchrun in torchruns.values()),
            # f32: split TF32 on mma.sync (the bf16 path's kernels above)
            "cuda_kernels": {
                "bfloat16": (["fa_fwd_wgmma"] if kind == "fwd" else
                             ["fa_delta", "fa_dq_wgmma", "fa_dkv_wgmma",
                              "fa_dkv_reduce"]),
                "float32": (["fa_fwd_tf32"] if kind == "fwd" else
                            ["fa_dq_tf32", "fa_dkv_tf32", "fa_dkv_reduce"])},
            "f32": {n: f32_case[n] for n in (
                "ms", "bound_ms", "bound_by", "bound_f32_ms", "library_ms",
                "plain_ms", "max_abs_err")},
            "f32_launches": sum(r["float32"]["k3_launches"][name]
                                for r in f32_steps.values()),
            "f32_launches_by_run": {run: r["float32"]["k3_launches"][name]
                                    for run, r in f32_steps.items()},
            "pass": True, "cases": flash_cases[kind]})
    for kind, name in (("fwd", "mamba2_ssd_fwd"), ("bwd", "mamba2_ssd_bwd")):
        case = ssd_cases[kind][0]            # L=4096, bf16: the path's case
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba2_scan.cu",
            "replaces": "src/repro/kernels/mamba2_scan.py:67",
            "launches": ztrain["launches"][name]
            + sum(torchrun[name] for torchrun in torchruns.values()),
            "launches_by_run": {zcfg.arch_id: ztrain["launches"][name],
                                **{run: torchrun[name] for run, torchrun
                                   in torchruns.items()}},
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None,
            "bound_f32_ms": case["bound_f32_ms"],
            "launches_ms": case.get("launches_ms"),
            "launches_sum_ms": case.get("launches_sum_ms"),
            "pass": True, "cases": ssd_cases[kind]})
    for kind, name in (("fwd", "rwkv6_wkv_fwd"), ("bwd", "rwkv6_wkv_bwd")):
        case = wkv_cases[kind][0]            # L=4096, bf16: the path's case
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan.py:65",
            "launches": rtrain["launches"][name]
            + sum(torchrun[name] for torchrun in torchruns.values()),
            "launches_by_run": {rcfg.arch_id:
                                rtrain["launches"][name],
                                **{run: torchrun[name] for run, torchrun
                                   in torchruns.items()}},
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None,
            "bound_tf32_ms": case["bound_tf32_ms"],
            "bound_sfu_ms": case["bound_sfu_ms"],
            "bound_bytes_ms": case["bound_bytes_ms"],
            "bound_f32_ms": case["bound_f32_ms"],
            "launches_ms": case.get("launches_ms"),
            "launches_sum_ms": case.get("launches_sum_ms"),
            "pass": True, "cases": wkv_cases[kind]})
    # K6 on its main path (phase 15's decode: 4 rows a group), K6b on its
    # (phase 17's training: 512 rows a group); bf16; and both under
    # torchrun (phase 21, reduced moonshot on the rank's groups)
    for kind, name, case, launched in (
            ("fwd", "gmm_fwd", gmm_cases["fwd"][0],
             mserve["launches"]["gmm_fwd"]),
            ("bwd", "gmm_bwd", gmm_cases["bwd"][2],
             mtrain["launches"]["gmm_bwd"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:40",
            "launches": launched + moonlight["launches"][name]
            + sum(torchrun[name] for torchrun in torchruns.values()),
            "launches_by_run": {
                f"{mcfg.arch_id}-serve": mserve["launches"][name],
                f"{mcfg.arch_id}-train": mtrain["launches"][name],
                f"{moonlight['arch']}-step": moonlight["launches"][name],
                **{run: torchrun[name] for run, torchrun
                   in torchruns.items()}},
            # the dropless dispatch that sorts the step's tables (no
            # kernel of its own: sort and gathers on the device)
            "moe_dispatch_by_run": {
                f"{moonlight['arch']}-step":
                    moonlight["launches"]["moe_dispatch"]},
            "dropless_table": moonlight["table"],
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "bound_f32_ms": case["bound_f32_ms"],
            "pass": True, "cases": gmm_cases[kind]
            + moonlight["gmm_cases"][kind]
            + ([{"ragged": gmm_cases["ragged"]}] if kind == "fwd" else [])})
    # the device entry of Genesys.invoke: one blocking CLOCK_GETTIME at
    # work-group granularity, the device's round trip against the plain
    # host entry's; the call is latency, bound by the same protocol's round
    # trip through a bare host responder
    wg = next(r for r in invoke["round_trip"] if r["call"] == "work_group")
    kernels.append({
        "name": "genesys_invoke", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/genesys_invoke.cu",
        "replaces": "src/repro/core/genesys/invoke.py:568",
        "launches": invoke["launches"],
        "max_abs_err": invoke["max_abs_err"], "ms": wg["ms"],
        "plain_ms": wg["plain_ms"],
        "bound_ms": invoke["bare_round_trip"]["ms"],
        "bound_old_wait_ms": invoke["bare_round_trip_old_wait"]["ms"],
        "bound_by": "latency", "library_ms": None,
        "native_doorbell": invoke["native_doorbell"],
        "pass": True, "cases": invoke["round_trip"]
        + [dict(invoke["bare_round_trip"], call="bare_responder"),
           dict(invoke["bare_round_trip_old_wait"],
                call="bare_responder_old_wait")]})
    # AdamW's kernels: they replace no Pallas kernel; they stand for the
    # reference's update under jit, one XLA fusion a leaf. Each training
    # phase checked its own run's counters (train_path_phase).
    adamw_by_run = {t["arch"]: t["adamw"] for t in (
        train, ztrain, rtrain, mtrain, etrain, moonlight)}
    kernels.append({
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "none: the XLA fusion of src/repro/optim/adamw.py "
                    "AdamW.update",
        **{k: sum(r[k] for r in adamw_by_run.values()) for k in (
            "sqnorm_launches", "fused_leaves", "plain_leaves")},
        "launches": sum(r["update_launches"] for r in adamw_by_run.values()),
        "launches_by_run": adamw_by_run,
        **{k: adamw_cases[0][k] for k in (
            "ms", "bound_ms", "bound_by", "plain_ms", "library_ms")},
        "max_abs_err": None, "pass": True, "cases": adamw_cases})
    print(json.dumps({"kernels": kernels, "main_path": dict(
        sc_main, build_s=build_s, logits_bf16_max_abs_diff=d_bf16,
        step_alone_ms=alone_ms, step_device_busy_ms=busy_ms,
        step_device_ops=step_ops, poller_spin=POLLER_SPIN,
        poller_max_sleep_s=POLLER_MAX_SLEEP_S,
        logits_f32_max_abs_diff=d_f32), "dense_path": dict(
        dense_runs, logits_bf16_max_abs_diff=d_dense),
        "train_path": train, "hybrid": {"train_path": ztrain,
                                         "serve": zserve},
        "ssm": {"train_path": rtrain, "serve": rserve},
        "moe": {"serve": mserve, "train_path": mtrain,
                "moonlight": {k: v for k, v in moonlight.items()
                              if k != "gmm_cases"}},
        "invoke": invoke,
        "encdec": {"serve": eserve, "train_path": etrain},
        "tools": tools, "fig12": fig12, "examples": examples,
        "phase_end_s": phase_end_s, "wall_s": time.perf_counter() - t_start}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

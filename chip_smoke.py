#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py            # from the root of a checkout

Three paths run, at k = 50, and the dense one again at k = 160, the
dense and sparse ones also through the distributed schedules (faun, naive,
gspmd, and faun and naive with the int8 panel wire) on a one-rank NCCL
group:

* dense: the paper's serial loop, ``NMFSolver(k, algo=...).fit(A)``, on a
  dense fp32 A at the paper's Video shape (m = 1,013,400, n = 13,824; A is
  56.04 GB), made on the device from ``--seed`` as low rank plus noise,
  through gram, ts_matmul, ts_matmul_t, and for the MU/HALS rules (mu,
  hals, amu, ahals) mu_update and hals_sweep;
* sparse: ``backend="sparse"`` on an Erdős–Rényi A at m = n = 2^24 with
  Webbase-2001's row density (8.633 nonzeros per row, 144.8 M nonzeros),
  values on (0, 1] made on the device, through spmm and spmm_sorted (and
  the LUC kernels);
* serving: ``FactorArtifact`` → ``FoldInProjector`` → ``TopK`` on the
  factors of the dense bpp fit (saved and loaded on local disk) and of the
  sparse mu fit (in memory), for dense and sparse request rows; on the
  factors of the dense mu fit, ``MicroBatcher``, the autotuned ``TopK``
  and ``MeshServer`` on a four-shard serve mesh of the card;
* the profiler (``fit(profile=True)``), the data generators and the
  checkpoints, at the same widths;
* the model stack (``repro_torch.models``): the ten architectures at their
  reduced configs, smollm-135m served at full size and four more at full
  width, depth cut; then the NMF compression of smollm-135m's FFN
  weights (``aunmf.fit``, bpp) through the dense kernels;
* training (``repro_torch.train``): every reduced architecture, then
  smollm-135m at full size and dbrx-132b at full width (one layer), and
  the sharded step and ``moe_ep`` on a one-rank NCCL mesh;
* tensor and sequence parallelism over "model" on four ranks sharing the
  card: smollm-135m's train step and serving, qwen2-72b's serving; the
  recurrent mixers split: recurrentgemma-9b's and xlstm-125m's train step
  and serving.

Phases, each of which raises on failure:

  1. card      nvidia-smi's name and power limit;
  2. build     nvcc builds every kernel of the paths from csrc/, in parallel;
  3. data      the dense A on the device;
  4. kernels   each dense kernel against its plain PyTorch version
               (kernels/ref.py) in fp32 and bf16, at the path's widths on a
               65,536-row slice of A and at ragged shapes;
  5. small     the dense path on the card against the CPU path at 96×64;
  6. timings   each dense kernel at the full shape in fp32 against its plain
               version, then timed with CUDA events beside its bound, its
               plain version and one torch.matmul call; ts_matmul also at a
               served column batch's shape (256 × 1,013,400 · W), gram's
               slab kernel and reduction apart, and ts_matmul, ts_matmul_t
               and gram (and their plain versions) against float64 on 2,048
               rows;
  4b. luc      mu_update and hals_sweep against their plain versions in fp32
               and bf16, with ε = 1e-16 and ε = eps_for, at ragged shapes
               (k = 1, 50, 128) and at Video's W (1,013,400 × 50), with a
               row whose X·G is 0 and a zero diagonal entry of G
               (hals_sweep also against float64 sums: hals_errs); timed at
               full width beside their bound and plain versions (hals_sweep
               beside its recorded time before its redesign too), in fp32
               and with a bf16 carry, mu_update also at k = 64 and 128;
               hals_sweep_norm (the HALS W-step's normalised sweep) against
               its plain column loop in fp32 and bf16, with both ε, at the
               same shapes (the ragged ones also on its wide head pass,
               the one k > 1,438 takes), a column that clamps to all zeros
               (the guard keeps it zero) and a repeat that must give the
               same bits; timed at full width beside its bound and the
               plain loop, in fp32 and bf16;
  7. main      fit() at the full shape: bpp for 10 iterations, then mu and
               hals for 3 each, with the launch counters reset just before
               each fit and read just after; the last rel error is checked
               against a direct ||A − WH|| / ||A||;
  7b. accel    amu and ahals (inner_iters=4, delta=0.01) for 3 iterations:
               ms/iter, the inner sweep counts, which the LUC launch counts
               must equal, and the rel error against the direct value;
  8. breakdown ms per iteration in each product and half-update (CUDA
               events around the backend's and the rule's calls);
  8b. serve    the bpp fit published as a FactorArtifact, saved and loaded
               (checksums verified), then FoldInProjector for bpp, mu, hals,
               amu and ahals (iters=100) on b = 1, 7, 64, 256 new rows and,
               through ``transposed()``, new columns: per-batch latency,
               launch counts; each result against the same fold with the
               plain LUC versions on the same R, R against its plain
               product, and both results' residuals ||a − xH||; TopK
               (cosine, k = 10) over W's rows, checked against a direct
               top-k;
  8c. wide    k = 160: mu_update, hals_sweep and hals_sweep's row-per-warp
               kernel (forced by its plan) at Video's W rows against their
               plain versions (fp32, bf16 carry; the sweeps also against
               float64: hals_errs) and timed; dense mu and hals fits for 2
               iterations, launches counted and the rel error checked
               against the direct value; a 64-row fold-in with mu and hals;
               a hals fold-in at k = 520, where the row-per-warp kernel
               runs by plan;
  9. sparse data      the sparse A as a BlockCOO, its nnz and bytes, and the
               time to build its sorted layout on the device;
 10. sparse kernels   spmm and spmm_sorted, A·B and Aᵀ·C, against their
               plain versions in fp32 and bf16, on the first 65,536 rows and
               at a ragged shape with a hot row and empty tiles;
 11. sparse timings   both kernels and both products at full size in fp32:
               checked, then timed beside their bound, their plain versions
               and one torch.sparse.mm call on a CSR copy, spmm_sorted
               checked bit-identical across two runs; spmm on the plan
               its wrapper chooses and on the other one (the L2-blocked
               scatter or a single pass), each checked and timed, with the
               plan and the rate printed;
 12. sparse main      fit() at full size: mu and hals for 3 iterations with
               spmm_impl="sorted" and with "auto" on an unsorted BlockCOO
               (the spmm kernel), bpp for 1 with "sorted"; launch counts,
               finiteness, nonnegativity and a direct float64 error;
 12b. sparse accel / luc  ahals for 2 iterations; mu_update and hals_sweep
               at the 2^24 × 50 factor, checked and timed as in phase 4b;
 13. sparse breakdown ms per iteration in mm, mm_t, each half-update, the
               grams and the rest, for mu and hals with each impl and for
               amu and ahals with the sorted one (bpp's
               one-iteration breakdown is left out to keep the run short;
               phase 12 times its iteration whole);
 14. sparse serve  an artifact of the sparse mu fit, in memory; sparse
               request rows at the matrix's density (b = 1, 256) through
               the spmm kernel (checked to take its single pass) and a
               hals fold-in, and each request's product timed on its
               single pass and on a forced L2-blocked scatter; TopK over
               W's 2^24 rows;
 15. faun      (after 8c, while the dense A is on the card) the paper's
               Algorithm 3, ``NMFSolver(K, algo, schedule="faun",
               grid=make_faun_grid(1, 1))``, on a one-rank NCCL group
               (NCCL puts no two ranks on one card): mu and hals for 3
               iterations, bpp for 1, each against the serial fit from the
               same seed: W, H and the rel errors bit-equal, the same
               kernel launches, A held as the given tensor (not a copy),
               peak memory (above what was allocated before the fit)
               within 1 GB of serial's, ms/iter beside serial's;
 15n. naive    Algorithm 2 at p = 1 on the same group: mu for 3 iterations,
               the same checks (both of its copies of A are views of A);
 15g. grid     (after ``del A``) faun on a 2×2 grid of four processes
               sharing the card over gloo, which takes CUDA tensors, at
               Video's width with m cut to 253,344: A made once by this
               process and handed to the ranks over CUDA IPC (each copies
               only its block); mu and hals for 3 iterations held against
               a float64 fit from the same seed (W and H no further from
               it than twice the serial fp32 fit is, + 1e-6 scaled; the
               rel errors no further, relatively, than 4× the serial fit's
               + 1e-6) and each rank's launches against the step's; A's
               memory back once the ranks are done;
 16. sparse faun  (after 14) faun at 1×1 on the sparse A: mu for 2
               iterations on the sorted layout, bit-equal to serial sorted;
               mu for 2 on "auto" (the spmm kernel, whose sums change
               order from run to run) within the sparse kernels'
               tolerance of serial "auto"; A held as given; peak memory
               within 1 GB of serial's, as in phase 15.
 17. compressed  (after 15n, and after 16 on the sparse A) the int8 panel
               wire, ``panel_compression="int8"``, on the one-rank NCCL
               group, where every panel is still quantised: faun 1×1 mu
               and hals for 3 iterations, bpp for 1, naive p = 1 mu for 3,
               sparse sorted faun mu for 2; each beside the exact fit of
               its schedule and seed: the direct ||A − WH|| / ||A||
               within ``COMPRESSED_DIRECT_TOL`` of the exact fit's (the
               reported int8 rel error, biased by the quantised
               byproducts as in the reference, printed beside it; none
               for bpp, whose H is left unchecked), W finite, the
               residuals' keys and shapes, finite and not all zero, the
               exact fit's launches, the peak memory above the exact
               fit's within the panels ``COMPRESSED_PEAK_PANELS`` allows;
               ms/iter beside the exact fit's and the quantiser's share;
 18. gspmd     the global-view schedule on the one-rank group: ``cuda``
               (plain tensors) for mu and hals, 3 iterations, bit-equal to
               serial; ``dense`` over a one-rank DeviceMesh (DTensors on
               the card, the rule on the rank's rows, so the LUC kernels
               launch) within a scaled 1e-4 of serial dense; sparse
               "auto" mu for 2 within the sparse kernels' tolerance of
               serial "auto"; every run with serial's launches; ms/iter
               beside serial's.
 19. profile   (after 8b) ``fit(profile=True)`` for mu and hals, 3
               iterations, serial on the dense A: the phase keys of
               ``expected_phases("serial")``, W, H and the rel errors
               bit-equal to the unprofiled fit from the same seed, its
               launches per iteration (the profiled fit runs one untimed
               iteration more), the phase times' sum within 25 % of the
               unprofiled ms/iter; each phase's ms and ``format_report``'s
               table on the card's published rates; faun 1×1 mu profiled
               on a one-rank NCCL group: the faun keys, serial's bits;
 20. generators and checkpoints  (before phase 3's A exists)
               ``video_like_matrix`` at Video's shape: its peak above what
               was allocated before it within A, its factors and four
               chunk-sized temporaries, its motion share within 1e-3;
               (after 19) ``bow_like_matrix`` and ``stream_batch`` at a few
               thousand rows, checked as the CPU tests check them, timed;
               the mu fit's factors and state through ``AsyncCheckpointer``
               and ``restore``, bit for bit, timed;
 21. batcher   1,000 single-row requests from 8 threads through
               ``MicroBatcher`` over the bpp and mu projectors of the mu
               fit, each result against ``project`` of its row alone as
               8b holds a served batch, the mean batch and the latencies from the
               registry; ``TopK(chunk=None)`` over W's 1,013,400 rows: the
               chosen chunk, every candidate's µs, the answer against
               ``chunk=4096``'s;
 22. mesh      ``MeshServer`` on ``serve_mesh(4, devices=[cuda:0] * 4)``
               and on one shard, shard="batch" and "features", both
               merges: codes against the single-device projector's as
               8b holds a served batch, the top-k and ``retrieve`` against the
               single-device ``TopK`` (rows whose scores tie within the
               rounding of two computations may trade places; one shard
               bit-equal), a served batch's launches (``ts_matmul`` once
               per shard, ``mu_update`` once per shard per sweep); a hot
               swap under load losing no request, a stale swap refused;
               the batch latency at p = 4 against p = 1.

 23. mixed     (after 15g) fault F2: Video's A in bf16 (28.0 GB), the
               products' bf16 A · fp32 B instantiation against the plain
               versions (row chunks) at full height, float64 on a
               65,536-row slice and a ragged shape, and the fp32 kernel on
               the slice widened (bit for bit); both timed beside the
               bytes bound; one bpp iteration on ``cuda`` at full height
               (launches, rel error against the direct value), the same
               fit at m = 253,344 against ``backend="dense"``, a bf16
               request batch on fp32 factors;
 24. elastic   (after 18, on the fp32 A) ``ElasticRunner``: mu, hals and
               amu killed at steps 2 and 4 of 6 and resumed, bit-equal to
               ``fit()``; a corrupt newest payload skipped; int8 faun 1×1
               and serial → faun 1×1 on a one-rank NCCL group, bit-equal;
               save blocking, write and restore seconds, the overhead of
               segments of 2 and 10 over the unsegmented fit;
 25. online    (after 23) ``OnlineNMF`` at Video's width: A0 of 262,144
               ``stream_batch`` rows, an initial hals fit of 10 iterations,
               12 batches of 4,096 rows on a scripted stream that takes
               extend, refresh and refactor; launches and ms per action,
               untouched H columns bit-equal through a refresh, the store
               never copied; then the same stream under 4 client threads:
               the same actions, stamps ≤ the latest version, 64 sampled
               codes against a cold fold on their version, the staleness
               share; rel_err against a from-scratch fit.
 26. models    (after 25) the model stack: every architecture's reduced
               config in fp32 (MoE at no-drop capacity), its forward
               finite and shaped (B, S, V), prefill 32 tokens and 3 decode
               steps each within ``DECODE_TOL`` of the forward; the
               reduced recurrentgemma at prompts 40 and 70, longer than
               its window and no multiple of it;
 27. serve     smollm-135m at full size in bf16, the port's seeded init:
               prefill 8 × 2,048 (the blockwise path), 32 greedy steps,
               twice (the same tokens): prefill ms and tokens/s, decode ms
               per step, peak memory above the weights; then
               recurrentgemma-9b, dbrx-132b, xlstm-125m and whisper-base
               at full width, depth cut as ``FULL_WIDTH_CUTS`` says (each
               cut printed), prefill and 4 decode steps.  Each is held
               against the fp32 forward of its own weights (dense
               attention): the bf16 decode within ``BF16_FACTOR`` × the
               bf16 forward's own distance, the fp32 twin's decode within
               ``DECODE_TOL``, its prefill within ``BLOCKWISE_TOL``;
 28. compress  examples/weight_compress.py on the port: |wi_up| of phase
               27's smollm-135m (17,280 × 1,536), bpp for 30 iterations
               through ``aunmf.fit`` on ``backend="cuda"`` at k = 4, 8,
               16, 32: rel_err, the compression ratio, ms/iter, exactly 3
               gram, 1 ts_matmul and 1 ts_matmul_t launches an iteration,
               rel_err within ``WC_REL_TOL`` of ``backend="dense"`` from
               the same W0/H0; the three kernels against their plain
               versions at k = 4 and 32, and timed at 32;
 29. train     (after 28) training (``repro_torch.train``): every
               architecture's reduced config in fp32, the gradients of one
               step on the card against the CPU port's from the same
               params and batch (``TRAIN_GRAD_TOL``), one adamw step, and
               five steps descending;
 30. train     smollm-135m at full size (bf16, remat, AdamW), cut from
               train_4k's 256 × 4,096 to 8 × 2,048: eight steps on one
               batch descend (ms a step, tokens/s, peak memory above the
               state); against an fp32 twin of the same weights, the
               bf16 loss within ``TRAIN_LOSS_TOL`` and the gradient
               within ``BF16_FACTOR`` × the bf16 forward's own distance;
               two microbatches against one within ``TRAIN_MB_TOL``;
               a ``train()`` loop of 6
               steps, checkpoints every 2, a failure injected at step 3,
               the only failure either loop absorbs (the steps each ran
               checked), bit-identical to the loop without it;
 31. train     dbrx-132b at full width, depth cut to 1 of 40 layers,
               Adafactor, 1 × 512: 3 steps, each finite, the factored
               state's shapes checked;
 32. train     the mesh on one card (a one-rank NCCL ``DeviceMesh``,
               ("data", "model")): the sharded step of reduced smollm
               bit-equal to the step without a mesh, ``moe_ep`` at
               mp = 1 against ``moe_local``, and reduced dbrx's sharded
               Adafactor step against the plain one (``EP_TOL``).
 33. count     (NMF part after 24, on the fp32 A) mu and hals counted on
               fake tensors of Video's shape (``lower_step``): the
               record's kernel calls equal a live iteration's LAUNCHES and
               its roofline bound on the H100 stays within
               ``BOUND_OVER_MEASURED`` of the measured ms per iteration;
               faun 1×1's record on a one-rank NCCL group equals the live
               iteration's wire log; (after 32) smollm-135m's prefill and
               train step counted beside phases 27 and 30's ms;
 34. dryrun    ``python -m repro_torch.launch.dryrun --nmf --no-save`` and
               the smollm-135m × train_4k × single cell, each a process
               of its own: every record ok, each NMF cell's wire within
               ``DRYRUN_WIRE_TOL`` of the cost model's, seconds and the
               HBM fit against this card's memory;
 35. pipeline  ``distributed.pipeline`` on four gloo ranks sharing the
               card, ``PIPE`` stages × microbatches in fp32: output and
               gradient within ``PIPE_TOL`` of the sequential stack.
 36. tp        tensor and sequence parallelism over "model" on four gloo
               ranks sharing the card, against the unsharded run on the
               card (``BF16_FACTOR`` × its own distance from an fp32
               twin): smollm-135m at full size (8 × 2,048, bf16) on
               (1, 3), where its heads, KV heads, FFN and vocabulary all
               divide, its train step's gradient and loss, prefill and 8
               decode steps on caches split over the KV length; its train
               step on (1, 4) with seq_parallel; qwen2-72b at full width,
               2 of 80 layers, prefill 2 × 2,048 and 8 decode steps on
               (1, 4), its bytes a rank against the card's memory.
 37. tp_rec    the recurrent mixers split over "model" on four gloo ranks
               sharing the card, by the same rules: recurrentgemma-9b at
               full width, one period (rglru, rglru, local_attn) of its 38
               layers, bf16, on (1, 4) (its RG-LRU on 1,024 of 4,096
               channels a rank): a train step at 2 × 1,024 (sgd: the
               gradient held leaf by leaf), prefill 2 × 2,048 and 8 decode
               steps on split caches, each rank's bytes and peak;
               xlstm-125m at full size on (1, 4) (its 4 mLSTM and sLSTM
               heads one a rank): a train step at 4 × 512, prefill 4 × 512
               and 8 decode steps; each recurrent mixer alone in fp32 at
               full width against itself whole (``TP_REC_FP32_TOL``); and
               a wholesale-bf16 xlstm-125m tree (every leaf bf16, the
               sLSTM's recurrent blocks too) loaded through
               ``lm_params_from_numpy`` and served unsharded.
 38. tp_heads  attention and the xLSTM cells on each rank's whole heads
               where they do not divide "model" (uneven), on three gloo
               ranks sharing the card, by the same rules: yi-34b at full
               width, 2 of 60 layers, bf16 (heads 19 / 19 / 18, KV heads
               read 0–2 / 2–5 / 5–7), prefill 2 × 2,048 and 8 decode
               steps; whisper-base at full size (3 / 3 / 2 in its
               encoder, self- and cross-attention), prefill 2 × 64 over
               1,500 frames and 8 decode steps; xlstm-125m at full size
               (2 / 1 / 1): a train step at 4 × 512, prefill 4 × 512 and
               8 decode steps; each uneven layer (yi's attention,
               whisper's cross-attention, xlstm's mLSTM and sLSTM) alone
               in fp32 against itself whole (``TP_REC_FP32_TOL``).

Last of all (the profiler doubles the host cost of every later launch,
tools/probe_profiler_overhead.py), one smollm-135m decode step of phase
27's shape is profiled: its kernels and device milliseconds.

Phase 15g also runs mu and hals with ``panel_compression="int8"`` on its
2×2 grid, each held by its direct ||A − WH|| / ||A|| against the exact
grid's, within ``GRID_COMPRESSED_DIRECT_TOL``.

Before the last line it prints the kernels as one JSON object; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  ``--m`` and ``--sparse-dim`` cut the two sizes for a
quicker run, and the cut is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

M_FULL, N_FULL, K = 1_013_400, 13_824, 50     # benchmarks/bench_datasets.py:19
CHECK_ROWS = 65_536
F64_ROWS = 2_048                              # rows held against float64
RAGGED = (4_099, 1_001, 70)                   # every axis ragged, k > 64
NOISE = 0.5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # scaled atol of test_kernels.py

# The sparse path keeps Webbase-2001's row density (118,142,155 rows and
# 1,019,903,190 nonzeros; its shape is benchmarks/bench_datasets.py:22) at
# m = n = 2^24, as many rows as one card holds beside the factors.
WEBBASE_ROWS, WEBBASE_NNZ = 118_142_155, 1_019_903_190
SPARSE_DIM = 1 << 24
SPARSE_ALIGN = 64                             # blocksparse.DEFAULT_ALIGN
SPARSE_CHECK_ROWS = 65_536
F64_ROWS = 2_048                              # rows held against float64

# H100 SXM (NVIDIA data sheet): fp32 outside the tensor cores, dense TF32
# and bf16 on them, HBM3.  ts_matmul and gram run fp32 as three TF32
# products (3xTF32), so their bounds count three times the useful
# operations at the TF32 rate.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

KERNELS = {
    "gram": {"source": "src/repro_torch/kernels/csrc/gram.cu",
             "replaces": "src/repro/kernels/gram.py:42"},
    "ts_matmul": {"source": "src/repro_torch/kernels/csrc/ts_matmul.cu",
                  "replaces": "src/repro/kernels/ts_matmul.py:44"},
    "ts_matmul_t": {"source": "src/repro_torch/kernels/csrc/ts_matmul.cu",
                    "replaces": "src/repro/kernels/ts_matmul.py:76"},
    "spmm": {"source": "src/repro_torch/kernels/csrc/spmm.cu",
             "replaces": "src/repro/kernels/spmm.py:99"},
    "spmm_sorted": {"source": "src/repro_torch/kernels/csrc/spmm.cu",
                    "replaces": "src/repro/kernels/spmm.py:189"},
    "mu_update": {"source": "src/repro_torch/kernels/csrc/luc.cu",
                  "replaces": "src/repro/kernels/mu_update.py:36"},
    "hals_sweep": {"source": "src/repro_torch/kernels/csrc/luc.cu",
                   "replaces": "src/repro/kernels/hals_sweep.py:53"},
    "hals_sweep_wide": {"source": "src/repro_torch/kernels/csrc/luc.cu",
                        "replaces": "src/repro/kernels/hals_sweep.py:53"},
    # the HALS W-step's normalised sweep, which the reference leaves to XLA
    "hals_sweep_norm": {"source": "src/repro_torch/kernels/csrc/luc.cu",
                        "replaces": "src/repro/core/rules.py:105"},
    # the products' bf16 A · fp32 B instantiation (phase 23)
    "ts_matmul_mixed": {"source": "src/repro_torch/kernels/csrc/ts_matmul.cu",
                        "replaces": "src/repro/kernels/ts_matmul.py:44"},
    "ts_matmul_t_mixed": {
        "source": "src/repro_torch/kernels/csrc/ts_matmul.cu",
        "replaces": "src/repro/kernels/ts_matmul.py:76"},
}
# The wide-k phase's rank
K_WIDE = 160
# A rank no tile of hals_sweep's column-blocked kernel fits (fp32 k ≥ 516):
# phase 8c serves a hals fold-in there, through its row-per-warp kernel
# (hals_sweep_wide)
K_ROWWISE = 520
# hals_sweep's times at the phases' shapes before its column-blocked
# redesign, and its row-per-warp kernel's at the wide phase's shape, as
# PERF.md §6 records them (rows 7, 7w, 7r; NVIDIA H100 80GB HBM3, 700.00
# W), printed beside this run's
HALS_BEFORE_MS = {(M_FULL, K): "0.793–0.800",
                  (SPARSE_DIM, K): "12.59–12.68",
                  (M_FULL, K_WIDE): "29.66–29.70"}
WIDE_BEFORE_MS = {(M_FULL, K_WIDE): "29.66–29.70"}

LUC_RAGGED = ((4_099, 50), (4_099, 1), (4_099, 128))
# Common ranks whose X mu_update widens to fp32 (gcd(k, 32) > 2), timed at
# Video's W rows beside k = 50
MU_TIMED_KS = (64, 128)
SERVE_BATCHES = (1, 7, 64, 256)
SERVE_ALGOS = ("bpp", "mu", "hals", "amu", "ahals")
# A served batch is held against the same projection with the LUC kernels
# replaced by their plain versions on the same R (scaled, 100 sweeps of
# rounding), and R itself against its plain product (fp32 tolerance; 1e-4
# for a dense contraction longer than 65,536: the transposed fold's
# 1,013,400-term sums, which the ts_matmul kernel adds in order in one
# block where cuBLAS splits them); the two solutions of min ||a - xH||,
# x >= 0, must leave the same residual relative to ||a||.  R is held apart
# because the fold amplifies R's rounding where G is ill-conditioned (the
# transposed fold's G = WᵀW).
SERVE_TOL = {"codes": 1e-3, "product": 1e-5, "long product": 1e-4,
             "residual": 1e-5}
LONG_CONTRACTION = 65_536
TOPK_CHECK_ROWS = 65_536
F64_ROWS = 2_048                              # rows held against float64


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def scaled_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that over max |want|)."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / (want.float().abs().max().item() + 1e-9)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(read_bytes: int, write_bytes: int, flops: float,
             dtype: str) -> tuple[float, str]:
    t_bytes = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def col_scaled_err(got, want) -> tuple[float, float]:
    """(max |got − want|, the largest over columns of that column's max
    |got − want| over its max |want|): a column of huge values (the ε
    guard) cannot hide the error of the others."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(0).clamp_min(1e-30)
    return diff.max().item(), (diff.amax(0) / scale).max().item()


@contextlib.contextmanager
def plain_luc():
    """The LUC kernel wrappers of ``kernels.ops`` replaced by their plain
    versions (``kernels.ref``): the same projector's fold-in math without
    the LUC kernels, which a served batch is held against on the card."""
    from repro_torch.kernels import ops, ref
    saved = ops.mu_update, ops.hals_sweep
    ops.mu_update = lambda X, G, R, *, eps=ref.LUC_EPS: ref.mu_update(
        X, G, R, eps)
    ops.hals_sweep = lambda X, G, R, *, eps=ref.LUC_EPS: ref.hals_sweep(
        X, G, R, eps)
    try:
        yield
    finally:
        ops.mu_update, ops.hals_sweep = saved


def add_launches(total: dict, counts: dict) -> None:
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"[card] {out}")
    return out


def kernel_label(mangled: str) -> str:
    """A short name for a mangled kernel of ptxas's log, e.g.
    ``ts_matmul_tc_kernel<f32,7>``."""
    import re
    for num in re.finditer(r"\d+", mangled):
        end = num.end() + int(num.group())
        name, rest = mangled[num.end():end], mangled[end:]
        if not name.endswith("_kernel"):
            continue
        if not rest.startswith("I") or "EEv" not in rest:
            return name
        names = {"13__nv_bfloat16": "bf16", "f": "f32", "Lb1E": "true",
                 "Lb0E": "false"}
        args = []
        for a in re.findall(r"13__nv_bfloat16|S\d*_|Li\d+E|Lb[01]E|f",
                            rest[1:rest.index("EEv")]):
            # S<n>_: a substitution, here the type named before it
            args.append(args[-1] if a.startswith("S") else
                        names.get(a, a[2:-1]))
        return f"{name}<{','.join(args)}>"
    return mangled


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR}")
    for name in paths:
        kernel = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {kernel}: {line.strip()}")


def phase_kernels(A, Ht, W, errs: dict) -> None:
    """Each kernel against its plain version, fp32 and bf16, at the path's
    widths on a 65,536-row slice and at a ragged shape."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=A.device).manual_seed(1)
    m, n, k = RAGGED
    ragged = [torch.rand(s, generator=gen, device=A.device)
              for s in ((m, n), (n, k), (m, k))]
    cases = {"slice": (A[:CHECK_ROWS], Ht, W[:CHECK_ROWS]),
             "ragged": tuple(ragged)}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        for case, (a, b, w) in cases.items():
            a, b, w = a.to(dt), b.to(dt), w.to(dt)
            for name, got, want in (
                    ("ts_matmul", ops.ts_matmul(a, b), ref.ts_matmul(a, b)),
                    ("ts_matmul_t", ops.ts_matmul_t(a, w),
                     ref.ts_matmul_t(a, w)),
                    ("gram", ops.gram(w), ref.gram(w)),
                    ("gram", ops.gram(b), ref.gram(b))):
                torch.cuda.synchronize()
                abs_err, err = scaled_err(got, want)
                ok = err <= TOL[dname]
                log(f"[kernels] {name:12s} {dname:8s} {case:6s} "
                    f"{tuple(a.shape) if name != 'gram' else tuple(got.shape)}"
                    f" scaled err {err:.3e} (tol {TOL[dname]:.0e}) "
                    f"abs {abs_err:.3e} {'ok' if ok else 'FAIL'}")
                require(ok, f"{name} {dname} {case} disagrees with its plain "
                            f"version: {err:.3e} > {TOL[dname]}")
                e = errs.setdefault(name, [0.0, 0.0])
                e[0], e[1] = max(e[0], abs_err), max(e[1], err)
            del a, b, w
    torch.cuda.empty_cache()


def luc_problem(gen, r: int, k: int, x_dtype, r_dtype):
    """X (r, k) with a zero row (X·G = 0: the ε of the MU denominator), G a
    Gram with a zero diagonal entry when k > 2 (the sweep divides by ε),
    R (r, k)."""
    import torch
    dev = gen.device
    X = torch.rand((r, k), generator=gen, device=dev)
    X[r // 2] = 0.0
    C = torch.rand((64, k), generator=gen, device=dev)
    if k > 2:
        C[:, 2] = 0.0
    R = torch.rand((r, k), generator=gen, device=dev) * 5
    return X.to(x_dtype), C.T @ C, R.to(r_dtype)


def norm_problem(gen, r: int, k: int, x_dtype):
    """hals_sweep_norm's inputs: X near a planted X* with R = X*·G plus
    noise, so that most updates stay positive; for k > 1, column min(3,
    k − 1)'s R so negative that it clamps to all zeros (its norm 0: the
    guard keeps it).  G fp32, R fp32."""
    import torch
    dev = gen.device
    C = torch.rand((30, k), generator=gen, device=dev)
    G = C.T @ C
    X = torch.rand((r, k), generator=gen, device=dev)
    R = X @ G + 0.1 * torch.rand((r, k), generator=gen, device=dev)
    X *= 0.5 + torch.rand((r, k), generator=gen, device=dev)
    if k > 1:
        R[:, min(3, k - 1)] = -1e3
    return X.to(x_dtype), G, R


def phase_luc_norm(dev, gen, cases, errs: dict, label: str,
                   time_rows: int) -> dict:
    """hals_sweep_norm against its plain column loop (ref.hals_sweep_norm)
    on ``norm_problem``'s inputs: each case (r, k) in fp32 and with a bf16
    carry, with ε = 1e-16 and ε = eps_for, column-scaled within TOL, the
    clamped column exactly zero, and a second run the same bits, on its
    plan and, for r ≤ CHECK_ROWS, on the wide head pass (plan rows 0,
    which a k past the head pass's tiles takes); then
    timed at (time_rows, 50) in fp32 and bf16 beside its bound (X and R
    read once, G once, the output written once; 2·r·k² flops) and the
    plain loop."""
    import torch
    from repro_torch.core.rules import eps_for
    from repro_torch.kernels import ops, ref
    for (r, k), (dname, xdt) in (
            (c, d) for c in cases
            for d in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16))):
        X, G, R = norm_problem(gen, r, k, xdt)
        plan = ops.plan_hals_sweep_norm(
            r, k, torch.cuda.get_device_properties(dev).multi_processor_count)
        plans = [plan] + ([plan._replace(rows=0, head_blocks=plan.col_blocks)]
                          if r <= CHECK_ROWS else [])
        for eps, p in ((e, p) for e in (ref.LUC_EPS, eps_for(xdt))
                       for p in plans):
            got = ops.hals_sweep_norm(X, G, R, eps=eps, plan=p)
            same = torch.equal(got, ops.hals_sweep_norm(X, G, R, eps=eps,
                                                        plan=p))
            want = ref.hals_sweep_norm(X, G, R, eps)
            abs_err, err = col_scaled_err(got, want)
            zero = k == 1 or not bool(got[:, min(3, k - 1)].any())
            ok = (err <= TOL[dname] and got.dtype == xdt and same and zero
                  and bool(torch.isfinite(got.float()).all()))
            log(f"[luc] hals_sweep_norm {dname:8s} {label:6s} {(r, k)} "
                f"eps {eps:.1e} {tuple(p)} err {err:.3e} (tol "
                f"{TOL[dname]:.0e}) abs {abs_err:.3e}; repeat bit-equal "
                f"{same}; clamped column zero {zero} "
                f"{'ok' if ok else 'FAIL'}")
            require(ok, f"hals_sweep_norm {dname} {(r, k)} eps {eps} plan "
                        f"{tuple(p)}: err {err:.3e}, repeat bit-equal "
                        f"{same}, clamped column zero {zero}")
            e = errs.setdefault("hals_sweep_norm", [0.0, 0.0])
            e[0], e[1] = max(e[0], abs_err), max(e[1], err)
            del got, want
        del X, G, R
        torch.cuda.empty_cache()
    r, k = time_rows, K
    row = {"library_ms": None}
    for dname, xdt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        X, G, R = norm_problem(gen, r, k, xdt)
        eps = eps_for(xdt)
        size = X.element_size()
        b_ms, b_by = bound_ms(r * k * (size + 4) + 4 * k * k, size * r * k,
                              2.0 * r * k * k, "float32")
        kern = lambda: ops.hals_sweep_norm(X, G, R, eps=eps)
        plain = lambda: ref.hals_sweep_norm(X, G, R, eps)
        p1, k1, k2, p2 = (time_ms(f, n) for f, n in (
            (plain, 3), (kern, 10), (kern, 10), (plain, 3)))
        tag = "" if dname == "float32" else "_bf16"
        row.update({f"ms{tag}": min(k1, k2), f"plain_ms{tag}": min(p1, p2),
                    f"bound_ms{tag}": b_ms})
        if not tag:
            row["bound_by"] = b_by
        short = "fp32" if dname == "float32" else "bf16"
        log(f"[luc timings] hals_sweep_norm {short} {label} {(r, k)} kernel "
            f"{k1:.3f}/{k2:.3f} ms, plain loop {p1:.3f}/{p2:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}); "
            f"{(r * k * (2 * size + 4)) / (min(k1, k2) * 1e-3) / 1e9:.0f} "
            f"GB/s of the half-update's bytes")
        del X, G, R
        torch.cuda.empty_cache()
    return {"hals_sweep_norm": row}


def phase_luc(dev, cases, errs: dict, label: str, time_rows: int,
              mu_ks: tuple = ()) -> dict:
    """mu_update and hals_sweep against their plain versions: each case
    (r, k) in fp32 and with a bf16 carry (fp32 R), with ε = 1e-16 and
    ε = eps_for; then both timed in fp32 at (time_rows, 50) beside their
    bound, their plain versions and (mu) the three-op torch expression;
    mu_update also with a bf16 carry, and at (time_rows, k) for each k of
    ``mu_ks`` in fp32 and bf16, each checked against its plain version.
    Then hals_sweep_norm on the cases (``phase_luc_norm``)."""
    import torch
    from repro_torch.core.rules import eps_for
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(4)
    for (r, k), (dname, xdt) in (
            (c, d) for c in cases
            for d in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16))):
        X, G, R = luc_problem(gen, r, k, xdt, torch.float32)
        for eps in (ref.LUC_EPS, eps_for(xdt)):
            for name in ("mu_update", "hals_sweep"):
                got = getattr(ops, name)(X, G, R, eps=eps)
                want = getattr(ref, name)(X, G, R, eps)
                torch.cuda.synchronize()
                abs_err, err = col_scaled_err(got, want)
                extra = ""
                if name == "hals_sweep":
                    # phase 8c's note; and against float64 sums
                    err, note = hals_errs(got, want, X, G, R, eps, dname)
                    extra = f" ({note})"
                ok = (err <= TOL[dname] and got.dtype == xdt
                      and bool(torch.isfinite(got.float()).all()))
                log(f"[luc] {name:10s} {dname:8s} {label:6s} {(r, k)} "
                    f"eps {eps:.1e} err {err:.3e}{extra} "
                    f"(tol {TOL[dname]:.0e}) abs {abs_err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                require(ok, f"{name} {dname} {(r, k)} eps {eps} disagrees "
                            f"with its plain version: {err:.3e}")
                e = errs.setdefault(name, [0.0, 0.0])
                e[0], e[1] = max(e[0], abs_err), max(e[1], err)
                del got, want
        del X, G, R
    torch.cuda.empty_cache()
    r, k = time_rows, K
    X, G, R = luc_problem(gen, r, k, torch.float32, torch.float32)
    eps = eps_for(torch.float32)
    # X and R read once, the output written once; 2·r·k² flops
    b_ms, b_by = bound_ms(8 * r * k, 4 * r * k, 2.0 * r * k * k, "float32")
    out = {}
    for name, reps in (("mu_update", 20), ("hals_sweep", 20)):
        kern = lambda: getattr(ops, name)(X, G, R, eps=eps)
        plain = lambda: getattr(ref, name)(X, G, R, eps)
        p1, k1, k2, p2 = (time_ms(f, n) for f, n in (
            (plain, 3), (kern, reps), (kern, reps), (plain, 3)))
        row = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        extra = ""
        if name == "mu_update":
            row["torch_expr_ms"] = time_ms(
                lambda: X * (R / (torch.matmul(X, G) + eps)), 3)
            extra = (f", the three-op torch expression "
                     f"{row['torch_expr_ms']:.3f} ms")
        elif (r, k) in HALS_BEFORE_MS:
            extra = (f", before the redesign {HALS_BEFORE_MS[r, k]} ms "
                     f"(PERF.md)")
        out[name] = row
        log(f"[luc timings] {name:10s} fp32 {label} {(r, k)} kernel "
            f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms{extra}, "
            f"bound {b_ms:.3f} ms ({b_by}); "
            f"{12 * r * k / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s")
    # both with a bf16 carry (fp32 R): X read and written in 2 bytes
    Xb = X.bfloat16()
    eps = eps_for(torch.bfloat16)
    b_ms, b_by = bound_ms(6 * r * k, 2 * r * k, 2.0 * r * k * k, "float32")
    for name in ("mu_update", "hals_sweep"):
        kern = lambda: getattr(ops, name)(Xb, G, R, eps=eps)
        plain = lambda: getattr(ref, name)(Xb, G, R, eps)
        p1, k1, k2, p2 = (time_ms(f, n) for f, n in (
            (plain, 3), (kern, 20), (kern, 20), (plain, 3)))
        out[name].update({"ms_bf16": min(k1, k2),
                          "plain_ms_bf16": min(p1, p2),
                          "bound_ms_bf16": b_ms})
        log(f"[luc timings] {name:10s} bf16 {label} {(r, k)} kernel "
            f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}); "
            f"{8 * r * k / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s")
    del X, G, R, Xb
    torch.cuda.empty_cache()
    for k in mu_ks:
        for dname, xdt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            X, G, R = luc_problem(gen, r, k, xdt, torch.float32)
            eps = eps_for(xdt)
            got = ops.mu_update(X, G, R, eps=eps)
            abs_err, err = col_scaled_err(got, ref.mu_update(X, G, R, eps))
            require(err <= TOL[dname], f"mu_update {dname} {(r, k)} "
                    f"disagrees with its plain version: {err:.3e}")
            e = errs.setdefault("mu_update", [0.0, 0.0])
            e[0], e[1] = max(e[0], abs_err), max(e[1], err)
            del got
            kern = lambda: ops.mu_update(X, G, R, eps=eps)
            plain = lambda: ref.mu_update(X, G, R, eps)
            p1, k1, k2, p2 = (time_ms(f, n) for f, n in (
                (plain, 3), (kern, 10), (kern, 10), (plain, 3)))
            size = X.element_size()
            nbytes = r * k * (2 * size + 4)
            b_ms, b_by = bound_ms(nbytes - size * r * k, size * r * k,
                                  2.0 * r * k * k, "float32")
            plan = ops.plan_mu_update(r, k, size, torch.cuda
                                      .get_device_properties(dev)
                                      .multi_processor_count)
            tag = "" if dname == "float32" else "_bf16"
            out["mu_update"].update({f"ms_k{k}{tag}": min(k1, k2),
                                     f"plain_ms_k{k}{tag}": min(p1, p2),
                                     f"bound_ms_k{k}{tag}": b_ms})
            short = "fp32" if dname == "float32" else "bf16"
            log(f"[luc timings] mu_update  {short} {label} {(r, k)} "
                f"kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms, "
                f"bound {b_ms:.3f} ms ({b_by}); "
                f"{nbytes / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s; plan "
                f"{plan.rows} rows x {plan.stages} stages, {plan.blocks} "
                f"blocks, direct {plan.direct}; column-scaled err "
                f"{err:.3e} ok")
            del X, G, R
            torch.cuda.empty_cache()
    out.update(phase_luc_norm(dev, gen, cases, errs, label, time_rows))
    return out


def hals_errs(got, want, X, G, R, eps: float,
              dname: str) -> tuple[float, str]:
    """hals_sweep's kernel result ``got`` against its plain version
    ``want`` and float64 sums (ref.hals_sweep_f64): fp32 on the sweep's
    scale (ref.sweep_scaled_err) against both; bf16 column-scaled against
    the plain version (a bf16 output's rounding is relative to itself, not
    to the sums) and on the sweep's scale against float64.  The larger of
    the two, and a note with every distance and the plain version's own."""
    from repro_torch.kernels import ref
    exact = ref.hals_sweep_f64(X, G, R, eps)
    col = col_scaled_err(got, want)[1]
    vs_plain = ref.sweep_scaled_err(got, want, X, G, R, eps)
    vs_f64 = ref.sweep_scaled_err(got, exact, X, G, R, eps)
    plain_f64 = ref.sweep_scaled_err(want, exact, X, G, R, eps)
    note = (f"column-scaled vs the plain version {col:.3e}; on the sweep's "
            f"scale vs the plain version {vs_plain:.3e}, vs float64: kernel "
            f"{vs_f64:.3e}, plain version {plain_f64:.3e}")
    return max(vs_plain if dname == "float32" else col, vs_f64), note


def phase_small() -> None:
    """The whole path on the card against the CPU path (plain versions),
    at the parity tests' size."""
    import numpy as np
    from repro_torch.core.engine import NMFSolver
    rng = np.random.default_rng(9)
    m, n, k = 96, 64, 6
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + NOISE * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    for algo in ("mu", "hals", "bpp"):
        gpu = NMFSolver(k, algo=algo, max_iters=3).fit(A, W0=W0, H0=H0)
        cpu = NMFSolver(k, algo=algo, device="cpu", max_iters=3).fit(
            A, W0=W0, H0=H0)
        r_g, r_c = gpu.rel_errors.numpy(), cpu.rel_errors.numpy()
        w_err = (np.abs(gpu.W.cpu().numpy() - cpu.W.numpy()).max()
                 / np.abs(cpu.W.numpy()).max())
        log(f"[small] {algo:4s} rel errors card {r_g} cpu {r_c}; "
            f"W scaled err {w_err:.2e}")
        require(np.allclose(r_g, r_c, rtol=1e-4, atol=0) and w_err <= 1e-4,
                f"{algo} on the card disagrees with the CPU path")


def phase_timings(A, Ht, W, errs: dict) -> dict:
    """Each kernel at the full shape, and ts_matmul at a served column
    batch's shape: held against its plain version there (the slab plan and
    64-bit offsets of A differ from the slice's), then timed beside its
    bound, its plain version and one torch.matmul call; gram's slab kernel
    and reduction are also timed apart.  ts_matmul and gram, and their
    plain versions, are held against float64 on the first rows."""
    import torch
    from repro_torch.kernels import ops, ref
    m, n = A.shape
    k = Ht.shape[1]
    f4 = 4
    b = max(SERVE_BATCHES)
    C = A[:, :b].T.contiguous()      # b request columns, as phase 8b serves
    # (key, kernel, plain, library call, bytes read, bytes written, useful
    # flops, the units' rate, reps).  ts_matmul, ts_matmul_t and gram run
    # three TF32 products on the tensor cores; XᵀX is symmetric: its k·(k+1)/2
    # distinct entries need r multiply-adds each.
    plans = {
        "ts_matmul": (lambda: ops.ts_matmul(A, Ht),
                      lambda: ref.ts_matmul(A, Ht),
                      lambda: torch.matmul(A, Ht),
                      (m * n + n * k) * f4, m * k * f4, 2.0 * m * n * k,
                      "tf32", 3),
        "ts_matmul serve": (lambda: ops.ts_matmul(C, W),
                            lambda: ref.ts_matmul(C, W),
                            lambda: torch.matmul(C, W),
                            (b * m + m * k) * f4, b * k * f4,
                            2.0 * b * m * k, "tf32", 20),
        "ts_matmul_t": (lambda: ops.ts_matmul_t(A, W),
                        lambda: ref.ts_matmul_t(A, W),
                        lambda: torch.matmul(A.T, W),
                        (m * n + m * k) * f4, n * k * f4, 2.0 * m * n * k,
                        "tf32", 3),
        "gram": (lambda: ops.gram(W), lambda: ref.gram(W),
                 lambda: torch.matmul(W.T, W),
                 m * k * f4, k * k * f4, 1.0 * m * k * (k + 1), "tf32", 20),
    }
    for name, (kern, plain, *_) in plans.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        abs_err, err = scaled_err(got, want)
        ok = err <= TOL["float32"]
        shape = {"gram": tuple(got.shape), "ts_matmul serve": tuple(C.shape)}
        log(f"[kernels] {name:15s} float32  full   "
            f"{shape.get(name, tuple(A.shape))} scaled "
            f"err {err:.3e} (tol {TOL['float32']:.0e}) abs {abs_err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name} float32 at the full shape disagrees with its "
                    f"plain version: {err:.3e} > {TOL['float32']}")
        e = errs.setdefault(name.split()[0], [0.0, 0.0])
        e[0], e[1] = max(e[0], abs_err), max(e[1], err)
        del got, want
    # both against float64 on a slice: the distance to the plain version
    # above is that version's own fp32 rounding as much as the kernel's
    rows = min(F64_ROWS, m)
    a_s, w_s = A[:rows], W[:rows]
    f64 = {"ts_matmul": (ops.ts_matmul(a_s, Ht), ref.ts_matmul(a_s, Ht),
                         a_s.double() @ Ht.double()),
           "ts_matmul_t": (ops.ts_matmul_t(a_s, w_s), ref.ts_matmul_t(a_s, w_s),
                           a_s.double().T @ w_s.double()),
           "gram": (ops.gram(w_s), ref.gram(w_s), w_s.double().T @ w_s.double())}
    for name, (got, plain, want) in f64.items():
        torch.cuda.synchronize()
        k_err, p_err = (scaled_err(x.double(), want)[1] for x in (got, plain))
        log(f"[kernels] {name:15s} float32  vs float64 on {rows} rows: kernel "
            f"{k_err:.3e}, plain version {p_err:.3e} (scaled)")
        f64[name] = {"f64_err": k_err, "plain_f64_err": p_err}
    del a_s, w_s
    out = {name: dict(errs64) for name, errs64 in f64.items()}
    for name, (kern, plain, lib, rb, wb, flops, units, reps) in plans.items():
        # in turns: plain, kernel, kernel, plain (then the library call)
        p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kern, kern, plain))
        lib_ms = time_ms(lib, reps)
        # the bound at the rate of the units the kernel uses (3xTF32: three
        # products on the tensor cores)
        n_ops = 3 * flops if units == "tf32" else flops
        b_ms, b_by = bound_ms(rb, wb, n_ops, units)
        key, suffix = (name.split()[0],
                       "_serve" if name.endswith("serve") else "")
        row = out.setdefault(key, {})
        row.update({f"ms{suffix}": min(k1, k2), f"plain_ms{suffix}": min(p1, p2),
                    f"library_ms{suffix}": lib_ms,
                    f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by})
        extra = ""
        if units == "tf32":
            cores_ms, _ = bound_ms(rb, wb, flops, "float32")
            row[f"bound_ms_fp32_cores{suffix}"] = cores_ms
            extra = f" (on the fp32 cores {cores_ms:.3f} ms)"
        log(f"[timings] {name:15s} fp32 kernel {k1:.3f}/{k2:.3f} ms, plain "
            f"{p1:.3f}/{p2:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}){extra}; "
            f"{flops / (min(k1, k2) * 1e-3) / 1e12:.1f} TFLOP/s useful, "
            f"{(rb + wb) / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s")
    out["ts_matmul"]["serve_shape"] = [b, m, k]
    del C
    main, reduce = ops.gram_parts(W)
    main_ms, reduce_ms = time_ms(main, 20), time_ms(reduce, 20)
    plan = ops.plan_gram(m, k, W.element_size(),
                         torch.cuda.get_device_properties(
                             W.device).multi_processor_count)
    out["gram"].update({"main_ms": main_ms, "reduce_ms": reduce_ms,
                        "slabs": plan.slabs})
    log(f"[timings] gram(W) apart: slab kernel {main_ms:.4f} ms ({plan.slabs} "
        f"slabs of {plan.slab} rows, panels of {plan.panel}), reduction "
        f"{reduce_ms:.4f} ms")
    g_ht = time_ms(lambda: ops.gram(Ht), 50)
    b_ht, by_ht = bound_ms(n * k * f4, k * k * f4, 3.0 * n * k * (k + 1),
                           "tf32")
    out["gram"]["ms_gram_ht"] = g_ht
    log(f"[timings] gram(Ht)        fp32 kernel {g_ht:.4f} ms at {(n, k)}, "
        f"bound {b_ht:.4f} ms ({by_ht})")
    return out


#: LUC launches per iteration of a plain rule's serial fit: MU updates both
#: halves through mu_update; HALS its H-step through hals_sweep and its
#: normalised W-step through hals_sweep_norm.  On a grid (faun, naive) the
#: W-step's column norms are collectives, so it stays a plain column loop.
LUC_PER_ITER = {"mu": {"mu_update": 2},
                "hals": {"hals_sweep": 1, "hals_sweep_norm": 1}, "bpp": {}}
LUC_PER_ITER_GRID = {"mu": {"mu_update": 2}, "hals": {"hals_sweep": 1},
                     "bpp": {}}


def phase_main(A, seed: int, runs) -> tuple[dict, dict, object]:
    """Phase 7; also returns the bpp fit, which phase 8b serves."""
    import numpy as np
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.kernels import ops
    m, n = A.shape
    launches = {name: 0 for name in ops.LAUNCHES}
    summary = {}
    kept = None
    for algo, iters in runs:
        solver = NMFSolver(K, algo=algo, max_iters=iters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = solver.fit(A, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rels = res.rel_errors.numpy()
        log(f"[main] {algo:4s} {iters} iters at {(m, n, K)}: fit {wall:.2f} s "
            f"incl. set-up, {wall / iters:.3f} s/iter, peak memory "
            f"{peak:.2f} GB, launches {counts}")
        log(f"[main] {algo:4s} rel errors {rels.tolist()}")
        want = dict.fromkeys(counts, 0)
        want.update(gram=3 * iters, ts_matmul=iters, ts_matmul_t=iters)
        want.update({name: c * iters
                     for name, c in LUC_PER_ITER[algo].items()})
        require(counts == want, f"{algo}: launches {counts} != {want}")
        require(rels.shape == (iters,) and np.isfinite(rels).all(),
                f"{algo}: rel errors not finite: {rels}")
        require(tuple(res.W.shape) == (m, K) and tuple(res.H.shape) == (K, n),
                f"{algo}: factor shapes {res.W.shape} {res.H.shape}")
        require(bool(torch.isfinite(res.W).all() and torch.isfinite(res.H).all()
                     and res.W.min() >= 0 and res.H.min() >= 0),
                f"{algo}: factors not finite and nonnegative")
        if algo == "mu":
            require(bool(np.all(np.diff(rels) <= 0)),
                    f"mu rel errors increase: {rels}")
        direct = direct_rel_error(A, res.W, res.H)
        log(f"[main] {algo:4s} direct ||A-WH||/||A|| {direct:.6f} vs "
            f"trace-trick {rels[-1]:.6f}")
        # the trace trick loses digits to cancellation near the noise floor
        require(abs(direct - rels[-1]) <= 1e-2 * direct,
                f"{algo}: rel error {rels[-1]} disagrees with the direct "
                f"value {direct}")
        for name in launches:
            launches[name] += counts[name]
        summary[algo] = {"iters": iters, "s_per_iter": wall / iters,
                         "peak_gb": peak, "rel_errors": rels.tolist()}
        if algo == "bpp":
            kept = res
        del res
        torch.cuda.empty_cache()
    return launches, summary, kept


def phase_accel(A, seed: int, runs, backend=None, label="accel") -> tuple:
    """Phase 7b (and 12b): the accelerated rules, inner_iters=4 and
    delta=0.01, through fit(); the launch counters reset just before each
    fit and read just after.  The LUC launches must equal the inner sweeps
    the rule state counted (amu: both halves through mu_update; ahals: its
    H sweeps through hals_sweep, its normalised W sweeps through
    hals_sweep_norm)."""
    import numpy as np
    import torch
    from repro_torch.core import rules
    from repro_torch.core.engine import NMFSolver
    from repro_torch.kernels import ops
    sparse = backend is not None
    m, n = A.shape
    launches, summary = {}, {}
    for algo, iters in runs:
        rule = type(rules.get_rule(algo))(inner_iters=4, delta=0.01)
        solver = NMFSolver(K, algo=rule, max_iters=iters,
                           **({"backend": backend} if sparse else {}))
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = solver.fit(A, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        st = res.extras["rule_state"]
        rels = res.rel_errors.numpy()
        log(f"[{label}] {algo:5s} {iters} iters at {(m, n, K)}: fit "
            f"{wall:.2f} s incl. set-up, {wall / iters:.3f} s/iter; inner "
            f"sweeps {st}; launches {counts}")
        log(f"[{label}] {algo:5s} rel errors {rels.tolist()}")
        luc = ({"mu_update": st["inner_w"] + st["inner_h"]} if algo == "amu"
               else {"hals_sweep": st["inner_h"],
                     "hals_sweep_norm": st["inner_w"]})
        want = dict.fromkeys(counts, 0)
        if sparse:
            want["spmm_sorted"] = 2 * iters
        else:
            want.update(gram=3 * iters, ts_matmul=iters, ts_matmul_t=iters)
        want.update(luc)
        require(counts == want, f"{label} {algo}: launches {counts} != "
                                f"{want}")
        require(iters <= st["inner_w"] <= 4 * iters
                and iters <= st["inner_h"] <= 4 * iters,
                f"{label} {algo}: inner sweep counts {st} outside "
                f"[{iters}, {4 * iters}]")
        require(np.isfinite(rels).all() and bool(
            torch.isfinite(res.W).all() and res.W.min() >= 0
            and res.H.min() >= 0), f"{label} {algo}: factors or rel errors "
                                   f"not finite and nonnegative")
        direct = (direct_sparse_rel_error(A, res.W, res.H) if sparse
                  else direct_rel_error(A, res.W, res.H))
        log(f"[{label}] {algo:5s} direct ||A-WH||/||A|| {direct:.6f} vs "
            f"trace-trick {rels[-1]:.6f}")
        require(abs(direct - rels[-1]) <= 1e-2 * direct,
                f"{label} {algo}: rel error {rels[-1]} disagrees with the "
                f"direct value {direct}")
        add_launches(launches, counts)
        summary[algo] = {"iters": iters, "s_per_iter": wall / iters,
                         "inner": dict(st), "rel_errors": rels.tolist()}
        del res
        torch.cuda.empty_cache()
    return launches, summary


def timed_segment(A, seed: int, algo: str, iters: int, ops,
                  labels: dict) -> dict:
    """Where an iteration's time goes: CUDA events around each of the
    backend's products and each half-update of ``iters`` fixed iterations
    (the step is the engine's own; only the backend's and the rule's calls
    are wrapped, on the instances).  ``labels`` names the spans of mm, mm_t
    and gram (a name, or a function of the call's operand).  "other" is the
    host-clock wall time minus the spans: the error from byproducts, casts
    and the host loop.  The set-up of a fit (factor init and ||A||²) is
    timed on its own."""
    import torch
    from repro_torch.core import rules
    from repro_torch.core.engine import NMFSolver
    spans = []

    def timed(name, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            label = name(*args) if callable(name) else name
            spans.append((label, start, end))
            return out
        return run

    for method in ("mm", "mm_t", "gram"):
        setattr(ops, method, timed(labels[method], getattr(ops, method)))
    rule = rules.get_rule(algo)
    rule.update_w = timed("update_w", rule.update_w)
    rule.update_h = timed("update_h", rule.update_h)
    solver = NMFSolver(K, algo=rule, backend=ops, max_iters=iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = solver.prepare_state(A, seed=seed)
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t0) * 1e3
    spans.clear()
    t0 = time.perf_counter()
    solver.run_segment(rs, iters)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    per = {}
    for label, start, end in spans:
        per[label] = per.get(label, 0.0) + start.elapsed_time(end) / iters
    per["other"] = wall_ms - sum(per.values())
    per["wall"] = wall_ms
    per["prepare (once per fit)"] = prepare_ms
    del rs
    torch.cuda.empty_cache()
    return per


def phase_breakdown(A, seed: int, runs) -> dict:
    """Phase 8: the dense path's iteration, span by span."""
    from repro_torch.backends import CudaOps
    m = A.shape[0]
    labels = {"mm": "ts_matmul", "mm_t": "ts_matmul_t",
              "gram": lambda X: "gram(W)" if X.shape[0] == m else "gram(Ht)"}
    out = {}
    for algo, iters in runs:
        out[algo] = per = timed_segment(A, seed, algo, iters, CudaOps(),
                                        labels)
        log(f"[breakdown] {algo:4s} ms/iter over {iters} iters: "
            + ", ".join(f"{k} {v:.2f}" for k, v in per.items()))
    return out


# ---------------------------------------------------------------------------
# The distributed schedules on one card: a one-rank NCCL group
# ---------------------------------------------------------------------------

def _storage(A):
    """The tensor holding A's values: a BlockCOO's ``vals``, a DTensor's
    local shard, or A itself."""
    A = getattr(A, "vals", A)
    return A.to_local() if hasattr(A, "to_local") else A


@contextlib.contextmanager
def nccl_group():
    """A one-rank NCCL process group for a phase (NCCL puts no two ranks on
    one card), destroyed when the phase ends."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def segment_fit(A, seed: int, iters: int, on_solver=None, **solver_kw):
    """A fixed fit split as fit() runs it (prepare, the iterations, collect),
    each part synchronised and timed; the launch counters reset just before
    and read just after, the peak memory over all three above what was
    allocated before the fit (A and whatever the caller holds: an earlier
    fit's result among it).  ``on_solver`` is called with the solver before
    the fit.  Returns (result, launches, peak GB, ms per iteration, set-up
    ms, the data pointers of the A the schedule held)."""
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.kernels import ops
    solver = NMFSolver(K, max_iters=iters, **solver_kw)
    if on_solver is not None:
        on_solver(solver)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launches()
    t0 = time.perf_counter()
    rs = solver.prepare_state(A, seed=seed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solver.run_segment(rs, iters)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = solver.collect_result(rs)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    held = rs.A if isinstance(rs.A, tuple) else (rs.A,)
    ptrs = {_storage(a).data_ptr() for a in held}
    del rs
    return res, counts, peak, (t2 - t1) * 1e3 / iters, (t1 - t0) * 1e3, ptrs


def phase_schedules(A, seed: int, runs, card: str, label: str,
                    exact: bool = True, slack_gb: float = 1.0
                    ) -> tuple[dict, dict]:
    """Phases 15, 15n and 16: ``schedule="faun"`` on a 1×1 grid and
    ``schedule="naive"`` at p = 1, on a one-rank NCCL group, each against
    the serial fit from the same seed on the same A (HALS's with the plain
    W sweep that the schedules run, ``plain_w_sweep``).  At one rank the
    collectives are identities through NCCL and the step runs the serial
    step's operations in its order, so W, H and the rel errors must be the
    same bits (``exact``; a product whose sums change order from run to
    run, the spmm kernel's, is held at the sparse kernels' tolerance
    instead); the kernel launches must equal the serial fit's; the A the
    schedule holds must be the given A's storage (not a copy), and the
    peak memory of the fit (above what was allocated before it) must stay
    within ``slack_gb`` of the serial fit's.  ``runs`` holds (schedule,
    algo, iters, solver kwargs)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.faun import make_faun_grid
    launches, summary = {}, {}
    m, n = A.shape
    with nccl_group():
        grid = make_faun_grid(1, 1)
        # NCCL makes a group's communicator at its first collective: make
        # them here, timed, so the fits' times are steady state
        t0 = time.perf_counter()
        for group in (None, grid.world, grid.row_group, grid.col_group):
            dist.all_reduce(torch.zeros(1, device=A.device), group=group)
        torch.cuda.synchronize()
        comm_ms = (time.perf_counter() - t0) * 1e3
        log(f"[{label}] NCCL communicators of the default group and the "
            f"1×1 grid's three groups made in {comm_ms:.1f} ms")
        summary["nccl_setup_ms"] = comm_ms
        for schedule, algo, iters, kw in runs:
            tag = f"{schedule:5s} {algo:4s}"
            if "backend" in kw:
                tag += f" {kw['backend'].spmm_impl}"
            with plain_w_sweep():
                ser, s_counts, s_peak, s_ms, s_prep, _ = segment_fit(
                    A, seed, iters, algo=algo, **kw)
            sched_kw = dict(schedule=schedule, **kw)
            if schedule == "faun":
                sched_kw["grid"] = grid
            res, counts, peak, ms, prep, ptrs = segment_fit(
                A, seed, iters, algo=algo, **sched_kw)
            log(f"[{label}] {tag} {iters} iters at {(m, n, K)}: {ms:.2f} "
                f"ms/iter (serial {s_ms:.2f}), set-up {prep:.1f} ms (serial "
                f"{s_prep:.1f}), peak memory {peak:.3f} GB (serial "
                f"{s_peak:.3f}), launches {counts}; card {card}")
            log(f"[{label}] {tag} rel errors {res.rel_errors.tolist()}")
            require(counts == s_counts, f"{label} {tag}: launches {counts} "
                                        f"!= serial's {s_counts}")
            require(ptrs == {getattr(A, "vals", A).data_ptr()},
                    f"{label} {tag}: the schedule holds a copy of A")
            require(peak <= s_peak + slack_gb,
                    f"{label} {tag}: peak memory {peak:.3f} GB > serial's "
                    f"{s_peak:.3f} + {slack_gb:.2f} GB")
            if exact:
                for name, got, want in (
                        ("W", res.W, ser.W), ("H", res.H, ser.H),
                        ("rel errors", res.rel_errors, ser.rel_errors)):
                    require(torch.equal(got, want),
                            f"{label} {tag}: {name} not bit-equal to the "
                            f"serial fit's")
            else:
                tol = TOL["float32"]
                errs = {name: scaled_err(got, want)[1] for name, got, want in
                        (("W", res.W, ser.W), ("H", res.H, ser.H))}
                rels, s_rels = res.rel_errors.numpy(), ser.rel_errors.numpy()
                log(f"[{label}] {tag} scaled distance to the serial fit "
                    f"{errs}, rel errors {s_rels.tolist()}")
                require(all(e <= tol for e in errs.values())
                        and np.allclose(rels, s_rels, rtol=tol, atol=0),
                        f"{label} {tag}: outside {tol} of the serial fit")
            require(res.extras["rule_state"] == ser.extras["rule_state"],
                    f"{label} {tag}: rule state differs")
            add_launches(launches, counts)
            summary["/".join(tag.split())] = {
                "iters": iters, "ms_per_iter": ms, "serial_ms_per_iter": s_ms,
                "prepare_ms": prep, "serial_prepare_ms": s_prep,
                "peak_gb": peak, "serial_peak_gb": s_peak,
                "bit_equal": exact}
            del res, ser
            torch.cuda.empty_cache()
    return launches, summary


#: Phase 17's bound on a compressed fit's peak memory above the exact fit's,
#: in panel-sized buffers (rows × k fp32, the panel of A's longer side), as
#: PERF.md §6 predicted before the first run: the residuals the fit keeps
#: (dense faun: rs_w and gather_w, m × k each; sparse, m = n: rs_w,
#: gather_w, gather_h and rs_h) plus the quantiser's temporaries beside its
#: input (the old residual, tot, q and the fused scale, and one more while
#: the int8 sums are rescaled)
COMPRESSED_PEAK_PANELS = {"dense": 7, "sparse": 9}


def timed_quantiser(spans: list):
    """An ``on_solver`` hook timing every ``_ef_quantize`` call of a
    compressed solver with CUDA events (its MAX all-reduces included)."""
    import torch

    def hook(solver):
        quantize = solver.compress._ef_quantize

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = quantize(*args, **kwargs)
            end.record()
            spans.append((start, end))
            return out

        solver.compress._ef_quantize = timed

    return hook


#: Phase 17's bound on an int8 fit's direct rel error above the exact
#: fit's, set between what tools/probe_compressed_tolerance.py read on the
#: card (seeds 0–4; PERF.md §6) on a sound wire and with the reduce-scatter
#: dequantising each row with its neighbour's scale: mu sound ≤ 2.4e-6,
#: that fault ≥ 0.108 (the reference's own criterion, 5e-3 on a 1×1 grid,
#: lies between); hals sound 8.7e-3–5.2e-2 (3 iterations of int8 HALS
#: spread that far from seed to seed), that fault ≥ 0.120.  Dropping the
#: error feedback reads inside the sound spread for both (no bound on the
#: direct error after 3 iterations can see it).  bpp none: both packages'
#: int8 bpp gives non-finite H at k = 50 (tools/probe_compressed_fits.py)
COMPRESSED_DIRECT_TOL = {"mu": 5e-3, "hals": 8e-2}
#: Phase 15g's bound for its int8 fits, the same measure on the 2×2 grid:
#: sound mu ≤ 2.9e-5 and hals ≤ 2.1e-3, the row-scale fault ≥ 0.108 / 0.119
#: (the same probe)
GRID_COMPRESSED_DIRECT_TOL = 5e-3


def phase_compressed(A, seed: int, runs, card: str, label: str,
                     direct) -> tuple[dict, dict]:
    """Phase 17: ``panel_compression="int8"`` on a one-rank NCCL group, each
    run beside the exact fit of the same schedule and seed on the same A.
    At one rank every panel is still quantised (int8 payloads through
    NCCL's all-gather and all-to-all, the Grams through its int32 and MAX
    all-reduces).  Held: the int8 fit's direct ||A − WH|| / ||A||
    (``direct``) within ``COMPRESSED_DIRECT_TOL`` of the exact fit's (the
    exact fit's reported rel error within 1 % of its direct one); W
    finite; the residuals under the keys and shapes of
    ``init_faun_residuals`` / ``init_naive_residuals`` in fp32, finite and
    one at least not zero; the exact fit's kernel launches; the peak
    memory above the exact fit's within ``COMPRESSED_PEAK_PANELS``.  bpp's
    H is left unchecked (not finite at k = 50 in both packages), so bpp
    has no direct-error bound.  The
    int8 fit's reported rel error comes from byproducts that include the
    dequantised reduce-scatter (as in the reference), which its rounding
    biases: it is printed beside the direct value, not held to it.  Prints
    ms/iter beside the exact fit's and the quantiser's share of it.
    ``runs`` holds (schedule, algo, iters, solver kwargs, peak key)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.faun import init_faun_residuals, make_faun_grid
    from repro_torch.core.naive import init_naive_residuals
    launches, summary = {}, {}
    m, n = A.shape
    with nccl_group():
        grid = make_faun_grid(1, 1)
        for group in (None, grid.world, grid.row_group, grid.col_group):
            dist.all_reduce(torch.zeros(1, device=_storage(A).device),
                            group=group)
        torch.cuda.synchronize()
        for schedule, algo, iters, kw, peak_key in runs:
            tag = f"{schedule:5s} {algo:4s}"
            if schedule == "faun":
                kw = dict(kw, grid=grid)
                want_res = init_faun_residuals(grid, m, n, K)
            else:
                want_res = init_naive_residuals(1, m, n, K)
            ex, e_counts, e_peak, e_ms, _, _ = segment_fit(
                A, seed, iters, algo=algo, schedule=schedule, **kw)
            e_rels = ex.rel_errors.numpy()
            e_direct = direct(A, ex.W, ex.H)
            del ex
            torch.cuda.empty_cache()
            spans = []
            res, counts, peak, ms, prep, _ = segment_fit(
                A, seed, iters, on_solver=timed_quantiser(spans), algo=algo,
                schedule=schedule, panel_compression="int8", **kw)
            quant_ms = sum(a.elapsed_time(b) for a, b in spans) / iters
            rels = res.rel_errors.numpy()
            finite = bool(torch.isfinite(res.W).all()
                          and torch.isfinite(res.H).all())
            nonfinite = int((~torch.isfinite(res.W)).sum()
                            + (~torch.isfinite(res.H)).sum())
            d = direct(A, res.W, res.H) if finite else float("nan")
            panel_gb = max(m, n) * K * 4 / 1e9
            allowed = COMPRESSED_PEAK_PANELS[peak_key] * panel_gb
            log(f"[{label}] {tag} int8 {iters} iters at {(m, n, K)}: "
                f"{ms:.2f} ms/iter (exact {e_ms:.2f}), quantiser "
                f"{quant_ms:.2f} ms/iter ({100 * quant_ms / ms:.1f} %, "
                f"{len(spans) // iters} calls an iteration), peak memory "
                f"{peak:.3f} GB (exact {e_peak:.3f}; allowed + "
                f"{allowed:.3f}), launches {counts}; card {card}")
            log(f"[{label}] {tag} int8 direct ||A-WH||/||A|| {d:.6f} "
                f"(exact {e_direct:.6f}, gap {d - e_direct:+.3e}); reported "
                f"rel errors {rels.tolist()} (exact {e_rels.tolist()}); "
                f"{nonfinite} non-finite entries of W and H")
            require(abs(float(e_rels[-1]) - e_direct) <= 1e-2 * e_direct,
                    f"{label} {tag}: the exact fit's rel error {e_rels[-1]} "
                    f"disagrees with its direct value {e_direct}")
            require(bool(torch.isfinite(res.W).all()),
                    f"{label} {tag}: int8 W not finite")
            if algo in COMPRESSED_DIRECT_TOL:
                tol = COMPRESSED_DIRECT_TOL[algo]
                require(finite and abs(d - e_direct) <= tol,
                        f"{label} {tag}: int8 direct rel error {d} is more "
                        f"than {tol} from the exact fit's {e_direct}")
            got_res = res.extras["panel_residuals"]
            require(sorted(got_res) == sorted(want_res)
                    and all(tuple(got_res[k].shape) == tuple(v.shape)
                            and got_res[k].dtype == torch.float32
                            for k, v in want_res.items()),
                    f"{label} {tag}: residuals "
                    f"{ {k: tuple(v.shape) for k, v in got_res.items()} }")
            # every residual is taken before H's update, so they are
            # finite even where bpp's H is not
            require(all(bool(torch.isfinite(v).all())
                        for v in got_res.values())
                    and any(bool((v != 0).any()) for v in got_res.values()),
                    f"{label} {tag}: residuals not finite, or all zero")
            require(counts == e_counts, f"{label} {tag}: int8 launches "
                                        f"{counts} != the exact fit's "
                                        f"{e_counts}")
            require(peak <= e_peak + allowed,
                    f"{label} {tag}: int8 peak memory {peak:.3f} GB > the "
                    f"exact fit's {e_peak:.3f} + {allowed:.3f} GB")
            add_launches(launches, counts)
            summary["/".join(tag.split())] = {
                "iters": iters, "ms_per_iter": ms, "exact_ms_per_iter": e_ms,
                "quantiser_ms_per_iter": quant_ms, "prepare_ms": prep,
                "peak_gb": peak, "exact_peak_gb": e_peak,
                "rel_errors": rels.tolist(), "exact_rel_errors":
                    e_rels.tolist(), "direct_rel_error": d,
                "exact_direct_rel_error": e_direct, "nonfinite": nonfinite}
            del res, got_res
            torch.cuda.empty_cache()
    return launches, summary


def phase_gspmd(A, seed: int, runs, card: str, label: str) -> tuple[dict,
                                                                     dict]:
    """Phase 18: ``schedule="gspmd"`` on a one-rank NCCL group, each run
    beside the serial fit of the same backend and seed.  ``cuda`` runs on
    plain tensors (its kernels are opaque to DTensor), HALS's W-step
    through hals_sweep_norm as serial's: bit-equal to serial.
    ``dense`` and ``sparse`` run over a one-rank ``DeviceMesh`` (DTensors
    on the card), the rule on the rank's rows (``gspmd.rule_on_rows``), so
    the LUC kernels launch as serial's do (HALS's W-step, whose norms are
    summed over the mesh, as the plain loop: the serial fit runs it too,
    ``plain_w_sweep``): held within a scaled 1e-4
    (dense) or the sparse kernels' tolerance (sparse "auto", whose spmm
    sums change order from run to run) of the serial fit.  Every run
    launches serial's kernels, as many times.  ``runs`` holds (algo,
    iters, backend name, solver kwargs)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.faun import make_faun_grid
    launches, summary = {}, {}
    m, n = A.shape
    with nccl_group():
        grid = make_faun_grid(1, 1)
        for group in (None, grid.world, grid.row_group, grid.col_group):
            dist.all_reduce(torch.zeros(1, device=_storage(A).device),
                            group=group)
        for algo, iters, name, kw in runs:
            tag = f"gspmd {algo:4s} {name}"
            with (contextlib.nullcontext() if name == "cuda"
                  else plain_w_sweep()):
                ser, s_counts, s_peak, s_ms, _, _ = segment_fit(
                    A, seed, iters, algo=algo, **kw)
            res, counts, peak, ms, prep, ptrs = segment_fit(
                A, seed, iters, algo=algo, schedule="gspmd", grid=grid,
                **kw)
            log(f"[{label}] {tag} {iters} iters at {(m, n, K)}: {ms:.2f} "
                f"ms/iter (serial {s_ms:.2f}), peak memory {peak:.3f} GB "
                f"(serial {s_peak:.3f}), launches {counts}; card {card}")
            log(f"[{label}] {tag} rel errors {res.rel_errors.tolist()}")
            require(counts == s_counts, f"{label} {tag}: launches {counts} "
                                        f"!= serial's {s_counts}")
            require(ptrs == {_storage(A).data_ptr()},
                    f"{label} {tag}: the schedule holds a copy of A")
            if name == "cuda":
                for f, got, w in (("W", res.W, ser.W), ("H", res.H, ser.H),
                                  ("rel errors", res.rel_errors,
                                   ser.rel_errors)):
                    require(torch.equal(got, w), f"{label} {tag}: {f} not "
                                                 f"bit-equal to serial's")
            else:
                tol = 1e-4 if name == "dense" else TOL["float32"]
                errs = {f: scaled_err(g, w)[1] for f, g, w in
                        (("W", res.W, ser.W), ("H", res.H, ser.H))}
                rels, s_rels = res.rel_errors.numpy(), ser.rel_errors.numpy()
                log(f"[{label}] {tag} scaled distance to serial {errs}, "
                    f"serial rel errors {s_rels.tolist()}")
                require(all(e <= tol for e in errs.values())
                        and np.allclose(rels, s_rels, rtol=tol, atol=0),
                        f"{label} {tag}: outside {tol} of the serial fit")
            add_launches(launches, counts)
            summary[f"{algo}/{name}"] = {
                "iters": iters, "ms_per_iter": ms, "serial_ms_per_iter": s_ms,
                "prepare_ms": prep, "peak_gb": peak, "serial_peak_gb": s_peak}
            del res, ser
            torch.cuda.empty_cache()
    return launches, summary


#: Phase 15g's rows: a multiple of 16 near a quarter of Video's (m/4 rows of
#: W and m/2 of A a rank on the 2×2 grid)
GRID_M = 253_344


def grid_rank(box: list, out: str, seed: int, runs,
              compressed=()) -> None:
    """Phase 15g's rank: ``faun`` on the 2×2 grid of four gloo ranks that
    share the card, on the A the parent made (a CUDA tensor received over
    CUDA IPC in the one-item list ``box``; this rank copies only its
    block): ``runs`` exact, then ``compressed`` with
    ``panel_compression="int8"`` (saved as "<algo>_int8").  The rank lays
    out every run's state first and then drops A: the parent's memory is
    freed only once no rank holds A, and a rank that exits still holding
    it (in the arguments it was spawned with) leaks it.  Rank 0 writes the
    global result, every rank its kernel launches and ms per iteration."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.engine import NMFSolver
    from repro_torch.core.faun import make_faun_grid
    from repro_torch.kernels import ops
    A = box.pop()
    grid = make_faun_grid(2, 2)
    rank = dist.get_rank()
    sync = torch.cuda.synchronize if A.is_cuda else (lambda: None)
    fits = []
    for (algo, iters), comp in ([(r, None) for r in runs]
                                + [(r, "int8") for r in compressed]):
        solver = NMFSolver(K, algo=algo, schedule="faun", grid=grid,
                           device=A.device, max_iters=iters,
                           panel_compression=comp)
        name = algo if comp is None else f"{algo}_{comp}"
        fits.append((name, iters, solver, solver.prepare_state(A, seed=seed)))
    del A
    for algo, iters, solver, rs in fits:
        sync()
        dist.barrier()
        ops.reset_launches()
        t0 = time.perf_counter()
        solver.run_segment(rs, iters)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        counts = dict(ops.LAUNCHES)
        res = solver.collect_result(rs)
        torch.save({"launches": counts, "ms_per_iter": ms},
                   os.path.join(out, f"{algo}_r{rank}.pt"))
        if rank == 0:
            torch.save({"W": res.W.cpu(), "H": res.H.cpu(),
                        "rels": res.rel_errors},
                       os.path.join(out, f"{algo}.pt"))
        del rs, res
    del fits
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_w_sweep():
    """The HALS W-step's kernel (``ops.hals_sweep_norm``) replaced by its
    plain column loop, which the distributed schedules run (their column
    norms are collectives): the serial fit they are held against."""
    from repro_torch.kernels import ops, ref
    saved = ops.hals_sweep_norm
    ops.hals_sweep_norm = lambda X, G, R, *, eps=ref.LUC_EPS: (
        ref.hals_sweep_norm(X, G, R, eps))
    try:
        yield
    finally:
        ops.hals_sweep_norm = saved


@contextlib.contextmanager
def float64_luc():
    """The LUC kernel wrappers replaced by float64 arithmetic (MU's update,
    ``ref.hals_sweep_f64`` and the W-step's plain loop): with float64
    products, a fit in float64 from the same factors, which fp32 fits are
    held against."""
    from repro_torch.kernels import ops, ref
    saved = ops.mu_update, ops.hals_sweep, ops.hals_sweep_norm
    ops.mu_update = lambda X, G, R, *, eps=ref.LUC_EPS: X * (R / (X @ G
                                                                  + eps))
    ops.hals_sweep = lambda X, G, R, *, eps=ref.LUC_EPS: ref.hals_sweep_f64(
        X, G, R, eps)
    ops.hals_sweep_norm = lambda X, G, R, *, eps=ref.LUC_EPS: (
        ref.hals_sweep_norm(X, G, R, eps))
    try:
        yield
    finally:
        ops.mu_update, ops.hals_sweep, ops.hals_sweep_norm = saved


def float64_fit(A, seed: int, algo: str, iters: int):
    """The serial fit from ``seed``'s factors with every product, Gram and
    update in float64 (A is copied to float64 for it)."""
    import torch
    from repro_torch.backends import LocalOps
    from repro_torch.core.engine import NMFSolver

    class Float64Ops(LocalOps):
        name = "float64"

        def mm(self, A, B):
            return A @ B

        def mm_t(self, A, B):
            return A.T @ B

        def gram(self, X):
            return X.T @ X

    rs = NMFSolver(K, algo=algo).prepare_state(A, seed=seed)
    W0, H0 = rs.W.double(), rs.Ht.T.double()
    del rs
    with float64_luc():
        res = NMFSolver(K, algo=algo, backend=Float64Ops(),
                        max_iters=iters).fit(A.double(), W0=W0, H0=H0)
    torch.cuda.empty_cache()
    return res


#: Phase 15g's limit on the grid's rel errors: their largest relative
#: distance to the float64 fit's, as a factor of the serial fp32 fit's (+
#: 1e-6), between what ``tools/probe_grid_tolerance.py`` read on the card
#: (PERF.md §6): at most 1.88× on sound grids (seeds 0–4), 10.2× with the
#: gathered panels rounded to bf16
REL_F64_FACTOR = 4.0


def phase_grid(dev, seed: int, runs, card: str, rank_fn=grid_rank,
               check: bool = True, compressed=()) -> dict:
    """Phase 15g: ``faun`` on a 2×2 grid of four processes sharing the card
    over gloo (which takes CUDA tensors; NCCL puts no two ranks on one
    card), at Video's width with m cut to ``GRID_M``, and each rank's
    launches against the step's (3 gram, 1 ts_matmul, 1 ts_matmul_t and
    the rule's LUC an iteration).  The grid changes only the order of the
    sums, so the fit is held against a float64 fit from the same seed:
    W and H no further from it than twice the serial fp32 fit's own
    distance to it, plus 1e-6 (scaled), and the rel errors no further
    (relatively) than ``REL_F64_FACTOR`` times the serial fit's, plus
    1e-6.  HALS's W is ill-conditioned in fp32 at this rank: the serial
    fit sits ≈ 2.5e-3 (scaled) from the float64 one, and the grid as far;
    against serial itself hals's rel errors differ by 1.29e-4 at seed 2.
    The float64 fit is the serial schedule run by the same engine and
    rules in float64 (``float64_fit``): it witnesses the grid's schedule
    and collectives, not the rule code both share.  The serial fp32 fit
    runs its HALS W-step on the plain loop (``plain_w_sweep``), as the
    ranks do and as when the limits were read.  The factor 2 sits
    between what ``tools/probe_grid_tolerance.py`` read on the card: at
    most 1.13× the serial fit's distance on sound grids (seeds 0–4), at
    least 14.6× with the gathered panels rounded to bf16, and ≥ 347× with
    their blocks swapped.  ``compressed`` runs the same grid with
    ``panel_compression="int8"`` too, each held by its direct rel error
    against the exact grid's (``GRID_COMPRESSED_DIRECT_TOL``)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.data.pipeline import lowrank_matrix
    from repro_torch.kernels import ops
    from repro_torch.util import dist as rdist
    m, n = GRID_M, N_FULL
    log(f"[grid] cut: m = {m} of the Video shape's {M_FULL} (four ranks "
        f"share the card)")
    held_before = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = lowrank_matrix(gen, m, n, K, noise=NOISE)
    serial, exact, serial_ms = {}, {}, {}
    for algo, iters in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_w_sweep():       # the W-step the grid's ranks run
            serial[algo] = NMFSolver(K, algo=algo, max_iters=iters).fit(
                A, seed=seed)
        torch.cuda.synchronize()
        serial_ms[algo] = (time.perf_counter() - t0) * 1e3 / iters
        exact[algo] = float64_fit(A, seed, algo, iters)
    summary = {"shape": (m, n), "grid": (2, 2)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_grid_") as out:
        t0 = time.perf_counter()
        rdist.spawn(rank_fn, 4, [A], out, seed, runs, *(
                        (compressed,) if compressed else ()),
                    backend="gloo",
                    device=(f"cuda:{dev.index or 0}" if dev.type == "cuda"
                            else "cpu"))
        wall = time.perf_counter() - t0
        if dev.type == "cuda":      # A's memory, now that no rank holds it
            torch.cuda.ipc_collect()
        for algo, iters in runs:
            got = torch.load(os.path.join(out, f"{algo}.pt"))
            ranks = [torch.load(os.path.join(out, f"{algo}_r{r}.pt"))
                     for r in range(4)]
            ser = serial[algo]
            want = dict.fromkeys(ops.LAUNCHES, 0)
            want.update(gram=3 * iters, ts_matmul=iters, ts_matmul_t=iters)
            want.update({name: c * iters
                         for name, c in LUC_PER_ITER_GRID[algo].items()})
            ex = exact[algo]
            errs = {f: {"grid-serial": scaled_err(got[f], getattr(ser, f)
                                                  .cpu())[1],
                        "grid-float64": scaled_err(got[f], getattr(ex, f)
                                                   .cpu())[1],
                        "serial-float64": scaled_err(getattr(ser, f),
                                                     getattr(ex, f))[1]}
                    for f in ("W", "H")}
            rels, s_rels = got["rels"].numpy(), ser.rel_errors.numpy()
            r64 = ex.rel_errors.numpy()
            rel64 = {"grid": float(np.max(np.abs(rels - r64) / r64)),
                     "serial": float(np.max(np.abs(s_rels - r64) / r64))}
            ms = [r["ms_per_iter"] for r in ranks]
            log(f"[grid] faun {algo:4s} 2×2 {iters} iters at {(m, n, K)}: "
                f"{max(ms):.2f} ms/iter (slowest rank; ranks "
                f"{[round(x, 2) for x in ms]}; serial {serial_ms[algo]:.2f} "
                f"incl. set-up); scaled distances {errs}; rel errors "
                f"{rels.tolist()} (serial {s_rels.tolist()}), relative "
                f"distance to the float64 fit's {rel64}; launches per rank "
                f"{ranks[0]['launches']}; card {card}")
            summary[algo] = {"iters": iters, "ms_per_iter": ms,
                             "serial_ms_per_iter_incl_setup": serial_ms[algo],
                             "scaled_err": errs, "rel_errors": rels.tolist(),
                             "serial_rel_errors": s_rels.tolist(),
                             "float64_rel_errors": ex.rel_errors.tolist(),
                             "rel_float64": rel64}
            if not check:
                continue
            for r, row in enumerate(ranks):
                require(row["launches"] == want,
                        f"grid {algo} rank {r}: launches {row['launches']} "
                        f"!= {want}")
            require(rel64["grid"] <= REL_F64_FACTOR * rel64["serial"] + 1e-6,
                    f"grid {algo}: rel errors further from the float64 "
                    f"fit's than {REL_F64_FACTOR}× the serial fit's: "
                    f"{rel64}")
            for f, e in errs.items():
                require(e["grid-float64"] <= 2 * e["serial-float64"] + 1e-6,
                        f"grid {algo}: {f} further from the float64 fit "
                        f"than twice the serial fit is: {e}")
        for algo, iters in compressed:
            got = torch.load(os.path.join(out, f"{algo}_int8.pt"))
            exact = torch.load(os.path.join(out, f"{algo}.pt"))
            d, e_d = (direct_rel_error(A, r["W"].to(A.device),
                                       r["H"].to(A.device))
                      for r in (got, exact))
            rels = got["rels"].numpy()
            ms = [torch.load(os.path.join(out, f"{algo}_int8_r{r}.pt"))
                  ["ms_per_iter"] for r in range(4)]
            log(f"[grid] faun {algo:4s} 2×2 int8 {iters} iters: "
                f"{max(ms):.2f} ms/iter (slowest rank; exact "
                f"{max(summary[algo]['ms_per_iter']):.2f}); direct "
                f"||A-WH||/||A|| {d:.6f} (exact grid {e_d:.6f}, gap "
                f"{d - e_d:+.3e}); reported rel errors {rels.tolist()} "
                f"(exact grid {summary[algo]['rel_errors']}); card {card}")
            summary[f"{algo}_int8"] = {"iters": iters, "ms_per_iter": ms,
                                       "rel_errors": rels.tolist(),
                                       "direct_rel_error": d,
                                       "exact_direct_rel_error": e_d}
            if check:
                tol = GRID_COMPRESSED_DIRECT_TOL
                require(abs(d - e_d) <= tol,
                        f"grid {algo} int8: direct rel error {d} is more "
                        f"than {tol} from the exact grid's {e_d}")
        summary["spawn_s"] = wall
    del serial, exact, A
    torch.cuda.empty_cache()
    # A went to the ranks over CUDA IPC: its memory comes back only once
    # every rank has dropped it
    held = (torch.cuda.memory_allocated(dev) - held_before) / 1e9
    log(f"[grid] {held:.3f} GB still allocated after the phase")
    summary["held_after_gb"] = held
    if check:
        require(held < 1.0, f"grid: {held:.3f} GB still allocated after "
                            f"the phase (A is {m * n * 4 / 1e9:.2f} GB)")
    return summary


# ---------------------------------------------------------------------------
# The sparse path: NMFSolver(k, backend="sparse") on a Webbase-shaped matrix
# ---------------------------------------------------------------------------

def sparse_cases(blk, srt, B, C):
    """(kernel, product, kernel call, plain call) for both SpMM kernels and
    both products: A·B (B (n, k)) and Aᵀ·C (C (m, k)); ``blk`` is A's
    unsorted BlockCOO, ``srt`` its sorted copy."""
    from repro_torch.kernels import ops, ref
    m, n = blk.shape
    v, r, c = (t.reshape(-1) for t in (blk.vals, blk.rows, blk.cols))
    row = [t.reshape(-1) for t in (srt.vals, srt.rows, srt.cols,
                                   srt.row_tiles, srt.row_valid)]
    col = [t.reshape(-1) for t in (srt.t_vals, srt.t_rows, srt.t_cols,
                                   srt.col_tiles, srt.col_valid)]
    a = srt.align
    # as local_spmm calls them: A·B with the BlockCOO's row order, the
    # sorted products with the layout's cached first units
    rf, cf = srt.row_first.reshape(-1), srt.col_first.reshape(-1)
    return [
        ("spmm", "A·B",
         lambda **plan: ops.spmm(v, r, c, B, m, row_major=blk.row_major,
                                 **plan),
         lambda: ref.spmm(v, r, c, B, m)),
        ("spmm", "Aᵀ·C", lambda **plan: ops.spmm_t(v, r, c, C, n, **plan),
         lambda: ref.spmm(v, c, r, C, n)),
        ("spmm_sorted", "A·B",
         lambda: ops.spmm_sorted(*row, B, m, align=a, first=rf),
         lambda: ref.spmm_sorted(*row, B, m, align=a)),
        ("spmm_sorted", "Aᵀ·C",
         lambda: ops.spmm_sorted(*col, C, n, align=a, first=cf),
         lambda: ref.spmm_sorted(*col, C, n, align=a)),
    ]


def check_sparse(label: str, blk, srt, B, C, errs: dict) -> None:
    import torch
    dname = str(B.dtype).removeprefix("torch.")
    for name, prod, kern, plain in sparse_cases(blk, srt, B, C):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        abs_err, err = scaled_err(got, want)
        ok = err <= TOL[dname]
        log(f"[sparse kernels] {name:11s} {prod:4s} {dname:8s} {label:6s} "
            f"{blk.shape} nnz {blk.nnz} scaled err {err:.3e} (tol "
            f"{TOL[dname]:.0e}) abs {abs_err:.3e} {'ok' if ok else 'FAIL'}")
        require(ok, f"{name} {prod} {dname} {label} disagrees with its plain "
                    f"version: {err:.3e} > {TOL[dname]}")
        e = errs.setdefault(name, [0.0, 0.0])
        e[0], e[1] = max(e[0], abs_err), max(e[1], err)
        del got, want


def phase_sparse_data(dev, seed: int, dim: int) -> dict:
    """Phase 9: the Webbase-shaped Erdős–Rényi matrix on the device, as an
    unsorted 1×1 BlockCOO and its sorted copy (timed)."""
    import torch
    from repro_torch.core import blocksparse
    from repro_torch.data.pipeline import erdos_renyi_bcoo
    density = WEBBASE_NNZ / WEBBASE_ROWS / dim
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = blocksparse.blockify(erdos_renyi_bcoo(gen, dim, dim, density), 1, 1)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    srt = blk.sort_rows(align=SPARSE_ALIGN)
    torch.cuda.synchronize()
    t_sort = time.perf_counter() - t0
    coo_gb = sum(getattr(blk, f).numel() * getattr(blk, f).element_size()
                 for f in ("vals", "rows", "cols")) / 1e9
    srt_gb = sum(t.numel() * t.element_size() for t in (
        getattr(srt, f) for f in blocksparse.LEAVES)) / 1e9
    log(f"[sparse data] A {blk.shape} fp32, density {density:.4e} "
        f"({WEBBASE_NNZ / WEBBASE_ROWS:.3f} nonzeros per row, Webbase-2001), "
        f"nnz {blk.nnz} (round(density·m·n): repeated draws are redrawn), "
        f"made in {t_make:.2f} s; COO triplets "
        f"{coo_gb:.3f} GB")
    log(f"[sparse data] sorted layout (align {SPARSE_ALIGN}, both "
        f"orientations) built on the device in {t_sort:.3f} s: "
        f"{srt.vals.numel()} + {srt.t_vals.numel()} packed slots, "
        f"{srt_gb:.3f} GB")
    return {"blk": blk, "srt": srt, "sort_s": t_sort}


def phase_sparse_kernels(blk, errs: dict) -> None:
    """Phase 10: both SpMM kernels and both products against their plain
    versions, fp32 and bf16, on the first 65,536 rows of the matrix and at
    a ragged shape with a hot row and empty tiles."""
    import torch
    from repro_torch.core import blocksparse
    dev = blk.device
    n = blk.shape[1]
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = blk.rows.reshape(-1)
    cut = int((rows < SPARSE_CHECK_ROWS).sum())   # triplets are row-major
    head = blocksparse._pack_triplets(
        blk.vals.reshape(-1)[:cut], rows[:cut], blk.cols.reshape(-1)[:cut],
        SPARSE_CHECK_ROWS, n, 1, 1, cut, row_major=blk.row_major)
    m_r, n_r, k_r = RAGGED
    dense = torch.rand((m_r, n_r), generator=gen, device=dev)
    dense *= torch.rand((m_r, n_r), generator=gen, device=dev) < 0.002
    dense[1000:3000] = 0                          # empty tiles
    dense[3] = 1.0 - torch.rand(n_r, generator=gen, device=dev)   # hot row
    ragged = blocksparse.blockify(dense, 1, 1)
    del dense
    cases = {"slice": (head, K), "ragged": (ragged, k_r)}
    for dt in (torch.float32, torch.bfloat16):
        for label, (b, k) in cases.items():
            b = dataclasses.replace(b, vals=b.vals.to(dt))
            B = torch.rand((b.shape[1], k), generator=gen, device=dev).to(dt)
            C = torch.rand((b.shape[0], k), generator=gen, device=dev).to(dt)
            check_sparse(label, b, b.sort_rows(align=SPARSE_ALIGN), B, C,
                         errs)
            del b, B, C
    torch.cuda.empty_cache()


def phase_sparse_timings(blk, srt, errs: dict) -> dict:
    """Phase 11: both kernels and both products at full size in fp32:
    held against their plain versions, then timed beside their bound, their
    plain versions and one torch.sparse.mm call on a CSR copy of A (Aᵀ for
    the second product) built before the timed window."""
    import torch
    gen = torch.Generator(device=blk.device).manual_seed(3)
    m, n = blk.shape
    sms = torch.cuda.get_device_properties(blk.device).multi_processor_count
    B = torch.rand((n, K), generator=gen, device=blk.device)
    C = torch.rand((m, K), generator=gen, device=blk.device)
    check_sparse("full", blk, srt, B, C, errs)
    nnz = blk.nnz
    # compulsory bytes: the triplets once, the dense operand once, the
    # output once; flops 2·nnz·k
    rb, wb = nnz * 12 + n * K * 4, m * K * 4
    b_ms, b_by = bound_ms(rb, wb, 2.0 * nnz * K, "float32")
    gather_gb = nnz * K * 4 / 1e9
    log(f"[sparse timings] bound {b_ms:.3f} ms ({b_by}) per product from "
        f"{(rb + wb) / 1e9:.2f} GB; the B-row gathers alone move "
        f"{gather_gb:.1f} GB, {gather_gb / HBM_BYTES_PER_S * 1e12:.2f} ms at "
        f"full bandwidth")
    out = {name: {"bound_ms": b_ms, "bound_by": b_by}
           for name in ("spmm", "spmm_sorted")}
    # what the gathers make the kernels move: a B row per nonzero, the
    # triplets and the output once
    moved = nnz * K * 4 + nnz * 12 + m * K * 4
    out["spmm_sorted"]["gathered_bytes_ms"] = moved / HBM_BYTES_PER_S * 1e3
    for prod, rhs, offsets, vals, cols, tiles, valid, size in (
            ("A·B", B, srt.row_offsets, srt.vals, srt.cols, srt.row_tiles,
             srt.row_valid, (m, n)),
            ("Aᵀ·C", C, srt.col_offsets, srt.t_vals, srt.t_cols,
             srt.col_tiles, srt.col_valid, (n, m))):
        slot = torch.arange(srt.align, device=blk.device)
        keep = (slot[None, :] < valid.reshape(-1)[:, None]).reshape(-1)
        csr = torch.sparse_csr_tensor(
            offsets.reshape(-1), cols.reshape(-1)[keep],
            vals.reshape(-1)[keep], size, check_invariants=False)
        del keep
        lib_ms = time_ms(lambda: torch.sparse.mm(csr, rhs), 3)
        del csr
        torch.cuda.empty_cache()
        suffix = "" if prod == "A·B" else "_t"
        for name, p, kern, plain in sparse_cases(blk, srt, B, C):
            if p != prod:
                continue
            p1, k1, k2, p2 = (time_ms(f, 3) for f in (plain, kern, kern,
                                                       plain))
            out[name].update({f"ms{suffix}": min(k1, k2),
                              f"plain_ms{suffix}": min(p1, p2),
                              f"library_ms{suffix}": lib_ms})
            log(f"[sparse timings] {name:11s} {prod:4s} fp32 kernel "
                f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms, "
                f"torch.sparse.mm {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
                f"({b_by}); {(rb + wb) / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s "
                f"compulsory, {gather_gb / (min(k1, k2) * 1e-3):.0f} GB/s of "
                f"B-row gathers")
            if name == "spmm_sorted":
                same = torch.equal(kern(), kern())
                log(f"[sparse timings] spmm_sorted {prod:4s} bit-identical "
                    f"across two runs: {same}")
                require(same, f"spmm_sorted {prod} differs between runs")
            if name == "spmm":
                out[name].update(spmm_plans(
                    prod, kern, plain, rb + wb, suffix,
                    (nnz, m if prod == "A·B" else n, K, 4, sms,
                     prod == "A·B" and blk.row_major)))
    del B, C
    torch.cuda.empty_cache()
    return out


def spmm_plans(prod: str, kern, plain, nbytes: int, suffix: str,
               plan_args: tuple) -> dict:
    """spmm on the plan its wrapper chose for ``kern`` and on the other one
    (the L2-blocked scatter, or a single pass): the other checked against
    the plain version, both timed in turns, both plans printed.
    ``plan_args``: (nnz, m_out, k, itemsize, SMs, row_major) of the call."""
    import torch
    from repro_torch.kernels import ops
    nnz, m_out, k, size, sms, row_major = plan_args
    chosen = ops.plan_spmm(nnz, m_out, k, size, sms, row_major=row_major)
    other = ops.plan_spmm(nnz, m_out, k, size, sms, row_major=row_major,
                          bucketed=chosen.buckets == 1)
    other_call = lambda: kern(plan=other)
    _, err = scaled_err(other_call(), plain())
    torch.cuda.synchronize()
    require(err <= TOL["float32"], f"spmm {prod} on the other plan {other} "
                                   f"disagrees with its plain version: {err}")
    c1, o1, o2, c2 = (time_ms(f, 3) for f in (kern, other_call, other_call,
                                              kern))
    res = {}
    for tag, plan, t1, t2 in (("plan", chosen, c1, c2),
                              ("other", other, o1, o2)):
        log(f"[sparse timings] spmm        {prod:4s} {tag:5s} buckets "
            f"{plan.buckets} (2^{plan.shift} rows), scratch "
            f"{plan.scratch_bytes / 1e9:.3f} GB, {plan.per_warp} triplets a "
            f"warp: {t1:.3f}/{t2:.3f} ms, "
            f"{nbytes / (min(t1, t2) * 1e-3) / 1e9:.0f} GB/s compulsory"
            + (f"; scaled err {err:.3e}" if tag == "other" else ""))
        res[f"{tag}_ms{suffix}"] = min(t1, t2)
        res[f"{tag}_buckets{suffix}"] = plan.buckets
        res[f"{tag}_scratch_bytes{suffix}"] = plan.scratch_bytes
    return res


def direct_sparse_rel_error(blk, W, H, chunk: int = 1 << 22) -> float:
    """||A − WH||_F / ||A||_F without the trace trick, in float64: the cross
    term over A's nonzeros, ||WH||² from the two k×k Grams (WH itself would
    be m·n = 2^48 entries)."""
    import torch
    f64 = torch.float64
    Ht = H.T.contiguous()
    v, r, c = (t.reshape(-1) for t in (blk.vals, blk.rows, blk.cols))
    norm = torch.zeros((), dtype=f64, device=W.device)
    cross = torch.zeros((), dtype=f64, device=W.device)
    for s in range(0, v.numel(), chunk):
        a = v[s:s + chunk].to(f64)
        wh = (W[r[s:s + chunk].long()].to(f64)
              * Ht[c[s:s + chunk].long()].to(f64)).sum(1)
        norm += (a * a).sum()
        cross += (a * wh).sum()

    def gram64(X):
        G = torch.zeros((K, K), dtype=f64, device=X.device)
        for r0 in range(0, X.shape[0], chunk):
            Xc = X[r0:r0 + chunk].to(f64)
            G += Xc.T @ Xc
        return G

    quad = (gram64(W) * gram64(Ht)).sum()
    return float(((norm - 2 * cross + quad).clamp_min(0) / norm).sqrt())


def phase_sparse_main(blk, srt, seed: int, runs) -> tuple[dict, dict, object]:
    """Phase 12: fit() at full size, through the user's entry point, with
    the launch counters reset just before each fit and read just after.
    Also returns the mu fit on the sorted layout, which phase 14 serves."""
    import numpy as np
    import torch
    from repro_torch.backends import SparseOps
    from repro_torch.core.engine import NMFSolver
    from repro_torch.kernels import ops
    m, n = blk.shape
    launches = {name: 0 for name in ops.LAUNCHES}
    summary = {}
    kept = None
    for algo, iters, impl in runs:
        A = srt if impl == "sorted" else blk
        kernel = "spmm_sorted" if impl == "sorted" else "spmm"
        solver = NMFSolver(K, algo=algo, backend=SparseOps(spmm_impl=impl),
                           max_iters=iters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = solver.fit(A, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rels = res.rel_errors.numpy()
        tag = f"{algo:4s} {impl:6s}"
        log(f"[sparse main] {tag} {iters} iters at {(m, n, K)}: fit "
            f"{wall:.2f} s incl. set-up, {wall / iters:.3f} s/iter, peak "
            f"memory {peak:.2f} GB, launches {counts}")
        log(f"[sparse main] {tag} rel errors {rels.tolist()}")
        want = {name: 2 * iters if name == kernel else 0 for name in counts}
        want.update({name: c * iters
                     for name, c in LUC_PER_ITER[algo].items()})
        require(counts == want, f"{tag}: launches {counts} != {want}")
        require(rels.shape == (iters,) and np.isfinite(rels).all(),
                f"{tag}: rel errors not finite: {rels}")
        require(tuple(res.W.shape) == (m, K) and tuple(res.H.shape) == (K, n),
                f"{tag}: factor shapes {res.W.shape} {res.H.shape}")
        require(bool(torch.isfinite(res.W).all() and torch.isfinite(res.H).all()
                     and res.W.min() >= 0 and res.H.min() >= 0),
                f"{tag}: factors not finite and nonnegative")
        if algo == "mu":
            require(bool(np.all(np.diff(rels) <= 0)),
                    f"{tag}: mu rel errors increase: {rels}")
        direct = direct_sparse_rel_error(blk, res.W, res.H)
        log(f"[sparse main] {tag} direct ||A-WH||/||A|| {direct:.6f} vs "
            f"trace-trick {rels[-1]:.6f}")
        require(abs(direct - rels[-1]) <= 1e-2 * direct,
                f"{tag}: rel error {rels[-1]} disagrees with the direct "
                f"value {direct}")
        add_launches(launches, counts)
        summary[f"{algo}/{impl}"] = {"iters": iters, "s_per_iter": wall / iters,
                                     "peak_gb": peak,
                                     "rel_errors": rels.tolist()}
        if (algo, impl) == ("mu", "sorted"):
            kept = res
        del res
        torch.cuda.empty_cache()
    return launches, summary, kept


def phase_sparse_breakdown(blk, srt, seed: int, runs) -> dict:
    """Phase 13: the sparse path's iteration, span by span ("grams" sums
    the three Grams, plain XᵀX on this path)."""
    from repro_torch.backends import SparseOps
    labels = {"mm": "mm", "mm_t": "mm_t", "gram": "grams"}
    out = {}
    for algo, iters, impl in runs:
        A = srt if impl == "sorted" else blk
        out[f"{algo}/{impl}"] = per = timed_segment(
            A, seed, algo, iters, SparseOps(spmm_impl=impl), labels)
        log(f"[sparse breakdown] {algo:4s} {impl:6s} ms/iter over {iters} "
            f"iters: " + ", ".join(f"{k} {v:.2f}" for k, v in per.items()))
    return out


# ---------------------------------------------------------------------------
# Serving: FactorArtifact -> FoldInProjector -> TopK
# ---------------------------------------------------------------------------

def fold_residual(proj, req, X):
    """||a − x H|| / ||a|| per request row, in float64 from the Gram form
    ||a||² − 2 x·(a Hᵀ) + x G xᵀ (no (b, n) product of a wide request)."""
    import torch
    Ht = proj.Ht.double()
    if req.layout == torch.strided:
        a = req.double()
        a2, R = (a * a).sum(1), a @ Ht
    else:
        idx, v = req._indices(), req._values().double()
        b = req.shape[0]
        a2 = torch.zeros(b, dtype=torch.float64, device=v.device).index_add_(
            0, idx[0], v * v)
        R = torch.zeros((b, Ht.shape[1]), dtype=torch.float64,
                        device=v.device).index_add_(
            0, idx[0], v[:, None] * Ht[idx[1]])
    Xd = X.double()
    r2 = a2 - 2 * (Xd * R).sum(1) + ((Xd @ proj.G.double()) * Xd).sum(1)
    return (r2.clamp_min(0) / a2.clamp_min(1e-300)).sqrt()


def product_err(proj, req) -> tuple[float, float]:
    """(scaled error, tolerance) of the request's cross product R = a·Hᵀ
    through its kernel (ts_matmul, or spmm for a sparse request) against
    the plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    tol = SERVE_TOL["product"]
    if req.layout == torch.strided:
        got, want = ops.ts_matmul(req, proj.Ht), ref.ts_matmul(req, proj.Ht)
        if req.shape[1] > LONG_CONTRACTION:
            tol = SERVE_TOL["long product"]
    else:
        idx = req._indices().to(torch.int32)
        args = (req._values(), idx[0].contiguous(), idx[1].contiguous(),
                proj.Ht, req.shape[0])
        got, want = ops.spmm(*args), ref.spmm(*args)
    return scaled_err(got, want)[1], tol


def serve_batches(proj, requests, label: str, algo: str, kernel_of: dict,
                  iters: int) -> tuple[dict, dict]:
    """Answer each (b, request) of ``requests`` with ``proj``: one warm-up
    call, then a host-clock timed, synchronised call with the launch
    counters reset just before it and read just after, then the checks of
    SERVE_TOL (outside the counted window).  Returns (per-b latency ms,
    launches of the timed calls) and the last batch's codes."""
    import torch
    from repro_torch.kernels import ops
    lat, launches, codes = {}, {}, None
    for b, req, product in requests:
        proj.project(req)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        got = proj.project(req)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.LAUNCHES)
        # a sparse batch's output (b ≤ 256 rows, padded to its bucket) fits
        # L2: spmm's single pass
        single = product != "spmm" or ops.plan_spmm(
            req._nnz(), next(s for s in proj.buckets if s >= b), proj.k, 4,
            torch.cuda.get_device_properties(0).multi_processor_count
        ).buckets == 1
        with plain_luc():
            want = proj.project(req)
        torch.cuda.synchronize()
        _, err = scaled_err(got, want)
        r_err, r_tol = product_err(proj, req)
        res_got, res_want = (fold_residual(proj, req, X) for X in (got, want))
        res_diff = (res_got - res_want).abs().max().item()
        kernel = kernel_of.get(algo)
        luc = counts.get(kernel, 0) if kernel else 0
        ok = (tuple(got.shape) == (b, proj.k)
              and bool(torch.isfinite(got).all())
              and got.min().item() >= 0 and err <= SERVE_TOL["codes"]
              and r_err <= r_tol
              and res_diff <= SERVE_TOL["residual"]
              and counts[product] == 1 and single
              and (luc == iters if algo in ("mu", "hals") else
                   1 <= luc <= iters if kernel else
                   counts["mu_update"] == counts["hals_sweep"] == 0))
        log(f"[{label}] {algo:5s} b={b:4d} {ms:9.3f} ms; launches "
            f"{ {k: v for k, v in counts.items() if v} }; against the plain "
            f"versions: codes {err:.2e} (tol {SERVE_TOL['codes']:.0e}), R "
            f"{r_err:.2e} (tol {r_tol:.0e}), rel residual {res_diff:.2e} "
            f"(tol {SERVE_TOL['residual']:.0e}, of max "
            f"{res_got.max().item():.6f})"
            + ("; spmm single pass" if product == "spmm" and single else "")
            + f" {'ok' if ok else 'FAIL'}")
        require(ok, f"{label} {algo} b={b}: shape {tuple(got.shape)}, "
                    f"launches {counts}, codes {err:.3e}, R {r_err:.3e}, "
                    f"residual {res_diff:.3e}, spmm single pass {single}")
        lat[b] = ms
        add_launches(launches, counts)
        codes = got
    return lat, launches, codes


def check_topk(tk, codes, label: str) -> dict:
    """TopK over all of W (timed, host clock, synchronised), and the
    streaming scan over W's first rows against a direct full-score top-k
    there: the same scores, and each returned index scoring its value."""
    import torch
    from repro_torch.serve.topk import topk_rows
    tk.query(codes, k=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, idx = tk.query(codes, k=10)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rows = min(TOPK_CHECK_ROWS, tk.W.shape[0])
    W, norms = tk.W[:rows], tk.row_norms[:rows]
    v, i = topk_rows(W, codes, k=10, gram=tk.gram, metric="cosine",
                     row_norms=norms)
    Q = codes.float()
    Qt = Q @ tk.gram
    qn = torch.clamp_min(torch.sqrt(torch.clamp_min((Qt * Q).sum(1), 0)),
                         1e-12)
    full = (Qt @ W.T) / (torch.clamp_min(norms, 1e-12)[None, :] * qn[:, None])
    dv, _ = torch.topk(full, 10, dim=1)
    at = torch.gather(full, 1, i)
    err = max((v - dv).abs().max().item(), (at - v).abs().max().item())
    ok = (tuple(idx.shape) == (codes.shape[0], 10) and err <= 1e-5
          and bool((vals[:, :-1] >= vals[:, 1:]).all()))
    log(f"[{label}] TopK cosine k=10 over {tk.W.shape[0]} rows, "
        f"b={codes.shape[0]}: {ms:.3f} ms; scan vs direct top-k on the first "
        f"{rows} rows: max err {err:.2e} (tol 1e-05) {'ok' if ok else 'FAIL'}")
    require(ok, f"{label}: top-k disagrees with the direct scores: {err}")
    return {"rows": tk.W.shape[0], "b": codes.shape[0], "ms": ms}


def phase_serve_dense(A, res) -> tuple[dict, dict]:
    """Phase 8b: publish the bpp fit, save and load it (checksums verified),
    fold new rows and new columns in with every algorithm, then top-k."""
    import torch
    from repro_torch.serve.artifact import FactorArtifact
    from repro_torch.serve.foldin import FoldInProjector
    from repro_torch.serve.topk import TopK
    art = FactorArtifact.from_result(res, corpus="chip_smoke video")
    path = os.path.join(ROOT, "build", "serve", "video_bpp")
    t0 = time.perf_counter()
    art.save(path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = FactorArtifact.load(path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    HHt = torch.matmul(res.H, res.H.T)
    _, gerr = scaled_err(loaded.gram, HHt)
    ok = (torch.equal(loaded.W, art.W) and torch.equal(loaded.H, art.H)
          and torch.equal(loaded.gram, art.gram) and loaded.algo == "bpp"
          and loaded.meta == art.meta and gerr <= TOL["float32"])
    log(f"[serve] artifact W {tuple(art.W.shape)} H {tuple(art.H.shape)}: "
        f"saved in {t_save:.2f} s, loaded and verified in {t_load:.2f} s; "
        f"gram vs HHᵀ scaled err {gerr:.2e} {'ok' if ok else 'FAIL'}")
    require(ok, "the artifact does not round-trip through disk")
    kernel_of = {"mu": "mu_update", "amu": "mu_update", "hals": "hals_sweep",
                 "ahals": "hals_sweep"}
    art_t = loaded.transposed()
    rows = A[-max(SERVE_BATCHES):]
    cols = A[:, :max(SERVE_BATCHES)].T.contiguous()
    launches, summary = {}, {"save_s": t_save, "load_s": t_load}
    codes = None
    for algo in SERVE_ALGOS:
        for label, a, req in (("serve rows", loaded, rows),
                              ("serve cols", art_t, cols)):
            proj = FoldInProjector(a, algo=algo, iters=100, backend="cuda")
            reqs = [(b, req[:b], "ts_matmul") for b in SERVE_BATCHES]
            lat, counts, last = serve_batches(proj, reqs, label, algo,
                                              kernel_of, 100)
            add_launches(launches, counts)
            summary[f"{label.split()[1]}/{algo}"] = lat
            if label == "serve rows" and algo == "bpp":
                codes = last
            del proj
    del cols, art_t
    torch.cuda.empty_cache()
    summary["topk"] = check_topk(TopK(loaded, metric="cosine"), codes,
                                 "serve topk")
    return launches, summary


def phase_wide(A, seed: int, errs: dict) -> tuple[dict, dict, dict]:
    """Phase 8c, k = 160: mu_update, hals_sweep and hals_sweep's
    row-per-warp kernel (hals_sweep_wide, forced by its plan) at Video's W
    rows against their plain versions in fp32 and with a bf16 carry
    (hals_sweep also against float64 sums: hals_errs), each launch
    counted, then timed in fp32 beside their bound and plain versions;
    dense mu and hals fits for 2 iterations (launch counters reset just
    before each fit, read just after; the last rel error against a direct
    ||A − WH|| / ||A||); one fold-in batch of 64 rows with each of mu and
    hals on the hals fit's factors; and one with hals at K_ROWWISE, on a
    factor made from the seed, where the row-per-warp kernel serves.
    Returns (launches, summary, timings)."""
    import functools
    import numpy as np
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.core.rules import eps_for
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.artifact import FactorArtifact
    from repro_torch.serve.foldin import FoldInProjector
    t_phase = time.perf_counter()
    m, n = A.shape
    k = K_WIDE
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    rowwise = ops.HalsPlan(0, 0, 0, 0, ops.LUC_ROWWISE_BLOCKS_PER_SM * sms, 0)
    kernel_of = {"mu_update": ops.mu_update, "hals_sweep": ops.hals_sweep,
                 "hals_sweep_wide": functools.partial(ops.hals_sweep,
                                                      plan=rowwise)}
    plain_of = {"mu_update": ref.mu_update, "hals_sweep": ref.hals_sweep,
                "hals_sweep_wide": ref.hals_sweep}
    gen = torch.Generator(device=A.device).manual_seed(seed + 8)
    for dname, xdt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        X, G, R = luc_problem(gen, m, k, xdt, torch.float32)
        eps = eps_for(xdt)
        for name, kern in kernel_of.items():
            ops.reset_launches()
            got = kern(X, G, R, eps=eps)
            torch.cuda.synchronize()
            launched = ops.LAUNCHES[name]
            want = plain_of[name](X, G, R, eps)
            abs_err, err = col_scaled_err(got, want)
            extra = ""
            if name != "mu_update":
                # The sweep's x_i + (r_i − (X·G)_i) / G_ii cancels: at k =
                # 160 here (X·G)_i reaches 10³ while the new x_i clamp to 0
                # or stay ≈ 10⁻², so a column's maximum is no measure of
                # an fp32 sum's rounding.  fp32 is held against the plain
                # version and float64 on the scale of what each update adds
                # and cancels (ref.sweep_scaled_err), at TOL; bf16, whose
                # outputs round relative to themselves, column-scaled
                # against the plain version and on that scale against
                # float64.
                err, note = hals_errs(got, want, X, G, R, eps, dname)
                extra = f"; {note}"
            ok = (err <= TOL[dname] and got.dtype == xdt and launched == 1
                  and bool(torch.isfinite(got.float()).all()))
            log(f"[wide] {name:15s} {dname:8s} {(m, k)} err {err:.3e} abs "
                f"{abs_err:.3e}{extra} (tol {TOL[dname]:.0e}); launches "
                f"{launched} {'ok' if ok else 'FAIL'}")
            require(ok, f"{name} {dname} at k = {k} disagrees with its "
                        f"plain version: {err:.3e} (launches {launched})")
            e = errs.setdefault(name, [0.0, 0.0])
            e[0], e[1] = max(e[0], abs_err), max(e[1], err)
            del got, want
        del X, G, R
    torch.cuda.empty_cache()
    X, G, R = luc_problem(gen, m, k, torch.float32, torch.float32)
    eps = eps_for(torch.float32)
    b_ms, b_by = bound_ms(8 * m * k, 4 * m * k, 2.0 * m * k * k, "float32")
    timings = {}
    for name, kern_fn in kernel_of.items():
        kern = lambda: kern_fn(X, G, R, eps=eps)
        plain = lambda: plain_of[name](X, G, R, eps)
        p1, k1, k2, p2 = (time_ms(f, n) for f, n in (
            (plain, 2), (kern, 5), (kern, 5), (plain, 2)))
        timings[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": None, "shape": [m, k]}
        prior = {"hals_sweep": HALS_BEFORE_MS,
                 "hals_sweep_wide": WIDE_BEFORE_MS}.get(name, {}).get((m, k))
        before = f", recorded before {prior} ms (PERF.md)" if prior else ""
        log(f"[wide timings] {name:15s} fp32 {(m, k)} kernel {k1:.3f}/"
            f"{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms{before}, bound "
            f"{b_ms:.3f} ms ({b_by}); "
            f"{12 * m * k / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s")
    del X, G, R
    torch.cuda.empty_cache()
    launches, summary, kept = {}, {}, None
    for algo, iters in (("mu", 2), ("hals", 2)):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = NMFSolver(k, algo=algo, max_iters=iters).fit(A, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        rels = res.rel_errors.numpy()
        want = dict.fromkeys(counts, 0)
        want.update(gram=3 * iters, ts_matmul=iters, ts_matmul_t=iters)
        want.update({name: c * iters
                     for name, c in LUC_PER_ITER[algo].items()})
        direct = direct_rel_error(A, res.W, res.H)
        log(f"[wide] {algo:4s} k={k} {iters} iters: fit {wall:.2f} s incl. "
            f"set-up, launches {counts}; rel errors {rels.tolist()}, direct "
            f"||A-WH||/||A|| {direct:.6f}")
        require(counts == want, f"wide {algo}: launches {counts} != {want}")
        require(np.isfinite(rels).all() and bool(
            torch.isfinite(res.W).all() and torch.isfinite(res.H).all()
            and res.W.min() >= 0 and res.H.min() >= 0),
            f"wide {algo}: factors or rel errors not finite and nonnegative")
        require(abs(direct - rels[-1]) <= 1e-2 * direct,
                f"wide {algo}: rel error {rels[-1]} disagrees with the direct "
                f"value {direct}")
        add_launches(launches, counts)
        summary[algo] = {"iters": iters, "s_per_iter": wall / iters,
                         "rel_errors": rels.tolist(), "direct": direct}
        if algo == "hals":
            kept = res
        del res
        torch.cuda.empty_cache()
    art = FactorArtifact.from_result(kept)
    rows = A[-64:]
    for algo in ("mu", "hals"):
        proj = FoldInProjector(art, algo=algo, iters=100, backend="cuda")
        lat, counts, _ = serve_batches(
            proj, [(64, rows, "ts_matmul")], "serve wide", algo,
            {"mu": "mu_update", "hals": "hals_sweep"}, 100)
        add_launches(launches, counts)
        summary[f"foldin/{algo}"] = lat
        del proj
    del kept, art
    # a hals fold-in at a rank no tile fits: the row-per-warp kernel serves
    H = torch.rand((K_ROWWISE, n), generator=gen, device=A.device)
    proj = FoldInProjector(H, algo="hals", iters=100, backend="cuda")
    require(ops.plan_hals_sweep(64, K_ROWWISE, 4, sms).rows == 0,
            f"a tile of hals_sweep's column-blocked kernel fits k = "
            f"{K_ROWWISE}: the fold-in would not reach hals_sweep_wide")
    lat, counts, _ = serve_batches(
        proj, [(64, rows, "ts_matmul")], f"serve k={K_ROWWISE}", "hals",
        {"hals": "hals_sweep_wide"}, 100)
    add_launches(launches, counts)
    summary[f"foldin/hals_k{K_ROWWISE}"] = lat
    del proj, H
    torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[wide] phase 8c took {summary['phase_s']:.1f} s")
    return launches, summary, timings


def phase_serve_sparse(res, dim: int, seed: int) -> tuple[dict, dict]:
    """Phase 14: the sparse mu fit as an artifact in memory; sparse request
    rows at the matrix's density through the spmm kernel and a hals
    fold-in; top-k over W's rows."""
    import torch
    from repro_torch.data.pipeline import erdos_renyi_bcoo
    from repro_torch.serve.artifact import FactorArtifact
    from repro_torch.serve.foldin import FoldInProjector
    from repro_torch.serve.topk import TopK
    art = FactorArtifact.from_result(res)
    gen = torch.Generator(device=res.W.device).manual_seed(seed + 14)
    density = WEBBASE_NNZ / WEBBASE_ROWS / dim
    reqs = []
    for b in (1, 256):
        req = erdos_renyi_bcoo(gen, b, dim, density)
        log(f"[serve sparse] request b={b}: {req._nnz()} nonzeros over "
            f"{dim} columns")
        reqs.append((b, req, "spmm"))
    proj = FoldInProjector(art, algo="hals", iters=100)
    lat, launches, codes = serve_batches(proj, reqs, "serve sparse", "hals",
                                         {"hals": "hals_sweep"}, 100)
    plans = served_spmm_plans(proj.Ht, reqs)
    del proj
    torch.cuda.empty_cache()
    topk = check_topk(TopK(art, metric="cosine"), codes, "serve sparse topk")
    return launches, {"hals": lat, "topk": topk, "spmm_plans": plans}


def served_spmm_plans(Ht, reqs) -> dict:
    """Each sparse request's product a·Hᵀ through spmm on the plan its
    wrapper chooses (one pass: b ≤ 256 rows fit L2) and on the L2-blocked
    scatter forced onto the same output (buckets of the most rows, a power
    of two, that b // 37 holds, as the card tests force it), checked
    against the plain version and timed in turns.  b = 1 has no bucketed
    plan: its one row is one bucket."""
    import torch
    from repro_torch.kernels import ops, ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for b, req, _ in reqs:
        idx = req._indices().to(torch.int32)
        v, r, c = req._values(), idx[0].contiguous(), idx[1].contiguous()
        nnz, size = v.numel(), Ht.element_size()
        chosen = ops.plan_spmm(nnz, b, K, size, sms)
        require(chosen.buckets == 1, f"served spmm b={b}: plan {chosen} is "
                                     f"not a single pass")
        shift = max(1, b // 37).bit_length() - 1
        buckets = -(-b // (1 << shift))

        def call(plan=None):
            return ops.spmm(v, r, c, Ht, b, plan=plan)
        if buckets == 1:
            t = time_ms(call, 50)
            log(f"[serve sparse] spmm b={b:4d} ({nnz} triplets) single pass "
                f"{t:.4f} ms; no bucketed plan: one row is one bucket")
            out[b] = {"plan_ms": t, "bucketed_ms": None}
            continue
        forced = ops.SpmmPlan(buckets, shift, ops.SPMM_BUCKET_RUN,
                              ops.SPMM_BUCKET_BLOCKS_PER_SM * sms,
                              nnz * (8 + size))
        _, err = scaled_err(call(forced), ref.spmm(v, r, c, Ht, b))
        require(err <= SERVE_TOL["product"],
                f"served spmm b={b} on {forced} disagrees with its plain "
                f"version: {err}")
        c1, f1, f2, c2 = (time_ms(f, 50) for f in (
            call, lambda: call(forced), lambda: call(forced), call))
        log(f"[serve sparse] spmm b={b:4d} ({nnz} triplets) single pass "
            f"{c1:.4f}/{c2:.4f} ms; forced {buckets} buckets (2^{shift} "
            f"rows, scratch {forced.scratch_bytes} B) {f1:.4f}/{f2:.4f} ms; "
            f"scaled err {err:.3e}")
        out[b] = {"plan_ms": min(c1, c2), "bucketed_ms": min(f1, f2),
                  "bucketed_buckets": buckets}
    return out


# ---------------------------------------------------------------------------
# The profiler, the data generators, checkpoints and the rest of serving
# ---------------------------------------------------------------------------

# The video-like matrix at Video's shape is built a chunk of rows at a time:
# its peak above what was allocated before is A, its rank-20 factors and at
# most four chunk-sized fp32 temporaries (the chunk's product, the mask's
# draw, the mask, the object values: data/pipeline.py, 2^26 elements each)
VIDEO_RANK, VIDEO_MOTION = 20, 0.05
VIDEO_CHUNK_TEMPS = 4
# The bag-of-words matrix and the streaming batches at a few thousand rows
BOW_SHAPE, BOW_DOC_LEN = (4_000, 3_000), 100
# the rank-frequency slope over the 200 most frequent words: the CPU draws
# of the same generator at this size fall in -0.240 … -0.217 (seeds 0–5),
# the JAX package's at 2,000 × 400 in -0.275 … -0.241 (tests/test_torch_data.py)
BOW_SLOPE_BAND = (-0.35, -0.15)
STREAM_SHAPE = (4_096, 2_000, 20)                # rows, n, k
# The profiled fits' phase times summed, against the unprofiled ms/iter of
# the same run (a synchronisation per phase is all the profiler adds)
PROFILE_SUM_TOL = 0.25
# Phase 21: 1,000 single-row requests from 8 threads
BATCHER_REQUESTS, BATCHER_THREADS, BATCHER_MAX = 1_000, 8, 64
BATCHER_ALGOS = ("bpp", "mu")
TOPK_QUERIES = 64
MESH_SHARDS = 4
MESH_BATCH = 64


def topk_within_ties(tk, codes, ref_scores, ref_idx, got_idx):
    """How far an answer ``got_idx`` of top-k rows for ``codes`` is from
    the single-device ``tk``'s answer (``ref_scores``, ``ref_idx``): the
    largest difference, over max |ref_scores|, between each returned row's
    score under ``tk`` and the reference score at its rank, and the number
    of positions whose row differs.  Rows whose scores tie within the
    rounding of two computations may trade places; any other row scores
    far from the reference at its rank."""
    import torch
    Q = codes.float()
    Qt = Q @ tk.gram
    qn = torch.clamp_min(torch.sqrt(torch.clamp_min((Qt * Q).sum(1), 0)),
                         1e-12)
    at = (torch.einsum("bk,bjk->bj", Qt, tk.W[got_idx])
          / (torch.clamp_min(tk.row_norms[got_idx], 1e-12) * qn[:, None]))
    err = (at - ref_scores).abs().max().item() / (
        ref_scores.abs().max().item() + 1e-9)
    return err, int((got_idx != ref_idx).sum())


def card_machine():
    """The cost model's machine with the card's published rates (HBM3
    3.35 TB/s per fp32 word, fp32 67 TFLOP/s outside the tensor cores) and
    no message latency: a one-card run sends no message."""
    from repro_torch.core.costmodel import Machine
    return Machine(alpha=0.0, beta=4 / HBM_BYTES_PER_S,
                   gamma=1 / PEAK_FLOPS["float32"])


def phase_video_generator(dev, seed: int, m: int, n: int) -> dict:
    """Phase 20, first part (before A exists): ``video_like_matrix`` at
    Video's shape, its peak memory above what was allocated before it
    against A's bytes, its factors and VIDEO_CHUNK_TEMPS chunk-sized fp32
    temporaries, and its motion share (the entries off the low-rank
    background, rebuilt chunk by chunk from the same seed) within 1e-3 of
    VIDEO_MOTION; then freed."""
    import torch
    from repro_torch.data import pipeline
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    V = pipeline.video_like_matrix(
        torch.Generator(device=dev).manual_seed(seed), m, n,
        rank=VIDEO_RANK, motion=VIDEO_MOTION)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    a_bytes = m * n * 4
    budget = (a_bytes + (m + n) * VIDEO_RANK * 4
              + VIDEO_CHUNK_TEMPS * pipeline._CHUNK_ELEMS * 4)
    # the background: the same seed's first draws, the generator's chunks;
    # an entry moved when it differs from it by more than the rounding of
    # two fp32 products of the same chunk (an object value below that is
    # counted as no motion: a share of about 1e-5 of the moved ones)
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = torch.rand((m, VIDEO_RANK), generator=gen, device=dev)
    H = torch.rand((VIDEO_RANK, n), generator=gen, device=dev)
    moved = torch.zeros((), dtype=torch.int64, device=dev)
    rows = pipeline._chunk_rows(n)
    for r0 in range(0, m, rows):
        bg = W[r0:r0 + rows] @ H
        moved += ((V[r0:r0 + rows] - bg).abs()
                  > 1e-5 * bg.abs().clamp_min(1.0)).sum()
    share = moved.item() / (m * n)
    del V, W, H, bg
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    ok = peak <= budget and abs(share - VIDEO_MOTION) <= 1e-3
    log(f"[generators] video_like_matrix {(m, n)} rank {VIDEO_RANK} in "
        f"{t_make:.2f} s: peak {peak / 1e9:.3f} GB above base (A "
        f"{a_bytes / 1e9:.3f} GB; budget {budget / 1e9:.3f} GB), motion "
        f"share {share:.6f} (motion {VIDEO_MOTION}, tol 1e-3) "
        f"{'ok' if ok else 'FAIL'}; phase {phase_s:.1f} s")
    require(ok, f"video_like_matrix: peak {peak} B (budget {budget}), "
                f"motion share {share}")
    return {"make_s": t_make, "peak_gb": peak / 1e9, "share": share,
            "phase_s": phase_s}


def phase_profile(A, seed: int, runs, card: str) -> tuple[dict, dict, dict]:
    """Phase 19: ``fit(profile=True)`` for each (algo, iters) of ``runs``,
    serial at A's full width, beside the unprofiled fit from the same seed
    (its prepare and iterations timed apart): the phase keys those of
    ``expected_phases("serial")``, W, H and the rel errors bit-equal, the
    launches per iteration equal (the profiled fit runs one untimed
    iteration more), the phase times' sum within PROFILE_SUM_TOL of the
    unprofiled ms/iter; each phase's ms and ``format_report``'s table on
    the card's published rates.  Then faun 1×1 mu on a one-rank NCCL group:
    the faun keys, and serial's profiled bits.  Returns (launches, summary,
    the mu fit's result)."""
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.core.faun import make_faun_grid
    from repro_torch.kernels import ops
    from repro_torch.obs.phases import expected_phases
    from repro_torch.obs.report import breakdown_report, format_report
    t_phase = time.perf_counter()
    m, n = A.shape
    launches, summary, kept = {}, {}, None
    mach = card_machine()
    for algo, iters in runs:
        plain, counts, _, ms_iter, setup_ms, _ = segment_fit(
            A, seed, iters, algo=algo)
        solver = NMFSolver(K, algo=algo, max_iters=iters)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        prof = solver.fit(A, seed=seed, profile=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pcounts = dict(ops.LAUNCHES)
        pt = prof.extras["phase_times"]
        total_ms = sum(pt.values()) * 1e3
        same = (torch.equal(prof.W, plain.W) and torch.equal(prof.H, plain.H)
                and torch.equal(prof.rel_errors, plain.rel_errors))
        per_iter = all(pcounts[k] * iters == counts[k] * (iters + 1)
                       for k in counts)
        ok = (same and per_iter
              and tuple(pt) == expected_phases("serial")
              and abs(total_ms - ms_iter) <= PROFILE_SUM_TOL * ms_iter)
        log(f"[profile] {algo:4s} {iters} iters at {(m, n, K)}: phases (ms) "
            + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in pt.items())
            + f"; sum {total_ms:.3f} vs unprofiled {ms_iter:.3f} ms/iter "
            f"(tol {PROFILE_SUM_TOL:.0%}); profiled fit {wall:.2f} s; "
            f"launches {pcounts} over {iters + 1} iterations vs {counts} over "
            f"{iters}; bit-equal {same} {'ok' if ok else 'FAIL'}")
        require(ok, f"profile {algo}: keys {tuple(pt)}, bit-equal {same}, "
                    f"launches {pcounts} vs {counts}, sum {total_ms} vs "
                    f"{ms_iter} ms/iter")
        rows = breakdown_report(solver, prof, m, n, machine=mach)
        log(format_report(rows, title=f"[profile] {algo}: measured against "
                          f"the cost model on the card's published rates "
                          f"(3.35 TB/s, 67 TFLOP/s fp32, no latency), "
                          f"{card}"))
        add_launches(launches, pcounts)
        summary[algo] = {"phase_ms": {k: v * 1e3 for k, v in pt.items()},
                         "sum_ms": total_ms, "unprofiled_ms_per_iter": ms_iter,
                         "setup_ms": setup_ms, "report": rows}
        if algo == "mu":
            kept = prof
        del plain
    with nccl_group():
        grid = make_faun_grid(1, 1)
        t0 = time.perf_counter()
        ops.reset_launches()
        res = NMFSolver(K, algo="mu", schedule="faun", grid=grid,
                        max_iters=3).fit(A, seed=seed, profile=True)
        torch.cuda.synchronize()
        t_faun = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
    pt = res.extras["phase_times"]
    ok = (tuple(pt) == expected_phases("faun")
          and torch.equal(res.W, kept.W) and torch.equal(res.H, kept.H))
    log(f"[profile] faun 1×1 mu, one-rank NCCL group: phases (ms) "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in pt.items())
        + f"; {t_faun:.2f} s; serial's profiled bits "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"faun profile: keys {tuple(pt)}, bits differ from serial")
    add_launches(launches, counts)
    summary["faun_mu"] = {"phase_ms": {k: v * 1e3 for k, v in pt.items()},
                          "s": t_faun}
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[profile] phase 19 took {summary['phase_s']:.1f} s")
    return launches, summary, kept


def zipf_slope(X, top: int = 200) -> float:
    """Slope of log frequency against log rank over the ``top`` most
    frequent words (rows of a words × docs count matrix)."""
    import torch
    f = torch.sort(X.double().sum(1), descending=True).values[:top]
    r = torch.arange(1, top + 1, dtype=torch.float64, device=X.device)
    ok = f > 0
    x, y = r[ok].log(), f[ok].log()
    x, y = x - x.mean(), y - y.mean()
    return float((x * y).sum() / (x * x).sum())


def phase_generators_and_checkpoints(dev, seed: int, res) -> dict:
    """Phase 20, second part: ``bow_like_matrix`` and ``stream_batch`` at a
    few thousand rows and columns, checked as the CPU tests check them and
    timed; then the fit's factors and rule state saved and restored through
    ``AsyncCheckpointer``, bit for bit, timed."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpoint
    from repro_torch.data import pipeline
    t_phase = time.perf_counter()
    out = {}
    V, D = BOW_SHAPE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X = pipeline.bow_like_matrix(torch.Generator(device=dev).manual_seed(seed),
                                 V, D, doc_len=BOW_DOC_LEN)
    torch.cuda.synchronize()
    out["bow_ms"] = (time.perf_counter() - t0) * 1e3
    slope = zipf_slope(X)
    mean_len = float(X.sum(0).mean())
    sigma = (BOW_DOC_LEN / D) ** 0.5
    ok = (tuple(X.shape) == (V, D) and bool((X >= 0).all())
          and torch.equal(X, X.round())
          and BOW_SLOPE_BAND[0] <= slope <= BOW_SLOPE_BAND[1]
          and abs(mean_len - BOW_DOC_LEN) <= 3 * sigma)
    log(f"[generators] bow_like_matrix {(V, D)} in {out['bow_ms']:.2f} ms: "
        f"nonnegative integer counts, Zipf slope {slope:.4f} (band "
        f"{BOW_SLOPE_BAND}), mean document length {mean_len:.3f} "
        f"({BOW_DOC_LEN} ± {3 * sigma:.3f}) {'ok' if ok else 'FAIL'}")
    require(ok, f"bow_like_matrix: slope {slope}, mean length {mean_len}")
    del X
    rows, n, k = STREAM_SHAPE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = pipeline.stream_batch(seed, 5, rows=rows, n=n, k=k, drift=0.01,
                              noise=0.01)
    torch.cuda.synchronize()
    out["stream_ms"] = (time.perf_counter() - t0) * 1e3
    replay = torch.equal(a, pipeline.stream_batch(seed, 5, rows=rows, n=n,
                                                  k=k, drift=0.01,
                                                  noise=0.01))
    H = pipeline.stream_truth(seed, n, k).double()
    a0 = pipeline.stream_batch(seed, 5, rows=rows, n=n, k=k).double()
    ad = pipeline.stream_batch(seed, 5, rows=rows, n=n, k=k,
                               drift=0.01).double()
    Xc = torch.linalg.lstsq(H.T, a0.T).solution                  # (k, rows)
    resid = float((a0 - Xc.T @ H).norm() / a0.norm())
    H_alt = pipeline.stream_truth(seed + 1, n, k).double()
    drift_err = float((ad - a0 - 0.01 * 5 * Xc.T @ H_alt).abs().max())
    ok = (replay and tuple(a.shape) == (rows, n) and resid < 1e-6
          and drift_err < 1e-4)
    log(f"[generators] stream_batch {(rows, n)} k={k} in "
        f"{out['stream_ms']:.2f} ms: bit-identical on replay {replay}, rows "
        f"in the truth's row space (rel residual {resid:.2e}, tol 1e-6), "
        f"drift linear in step (max err {drift_err:.2e}, tol 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"stream_batch: replay {replay}, residual {resid}, drift "
                f"{drift_err}")
    del a, a0, ad
    state = {"W": res.W, "H": res.H, "rel_errors": res.rel_errors,
             "rule_state": res.extras["rule_state"],
             "seed": torch.tensor(seed)}
    ckdir = os.path.join(ROOT, "build", "checkpoints", "video_mu")
    ck = checkpoint.AsyncCheckpointer(ckdir, keep_last=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(state, res.iters)
    t_save = time.perf_counter() - t0
    ck.wait()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    template = {key: (torch.empty_like(v) if isinstance(v, torch.Tensor)
                      else v) for key, v in state.items()}
    back, step = checkpoint.restore(ckdir, template)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(ck.last_path, "arrays.npz"))
    ok = (step == res.iters and back["W"].device == res.W.device
          and all(torch.equal(back[key], state[key])
                  for key in ("W", "H", "rel_errors", "seed")))
    log(f"[checkpoint] W {tuple(res.W.shape)}, H, rel errors, rule state "
        f"through AsyncCheckpointer: save() returned in {t_save * 1e3:.1f} ms "
        f"(host copy), written in {t_write:.2f} s ({size / 1e6:.1f} MB), "
        f"restored to the card in {t_restore:.2f} s; bit for bit "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "the checkpoint does not round-trip bit for bit")
    out.update(save_ms=t_save * 1e3, write_s=t_write, restore_s=t_restore,
               mb=size / 1e6, phase_s=time.perf_counter() - t_phase)
    log(f"[generators] phase 20 (second part) took {out['phase_s']:.1f} s")
    return out


def phase_batcher(A, res) -> tuple[dict, dict]:
    """Phase 21: BATCHER_REQUESTS single-row submits from BATCHER_THREADS
    threads through ``MicroBatcher`` over the bpp and mu projectors of the
    fit's artifact, each result against ``project`` of that row alone as
    phase 8b holds a served batch (SERVE_TOL: the codes scaled, and both
    solutions' residuals; a batch's ``ts_matmul`` splits the 13,824-long
    sums by another plan than one row's, and the fold amplifies that
    rounding), the mean batch and latencies from the registry; then
    ``TopK(chunk=None)`` over W's rows: the chosen chunk, every candidate's
    µs, and the answer against ``chunk=4096``'s."""
    import threading
    import numpy as np
    import torch
    from repro_torch.kernels import autotune, ops
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve.artifact import FactorArtifact
    from repro_torch.serve.batcher import MicroBatcher
    from repro_torch.serve.foldin import FoldInProjector
    from repro_torch.serve.topk import TopK
    t_phase = time.perf_counter()
    art = FactorArtifact.from_result(res)
    rows = A[:BATCHER_REQUESTS]
    launches, summary = {}, {}
    for algo in BATCHER_ALGOS:
        proj = FoldInProjector(art, algo=algo, iters=100,
                               max_batch=BATCHER_MAX)
        proj.warmup()
        reg = MetricsRegistry()
        results, lat = {}, []
        lock = threading.Lock()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with MicroBatcher(proj.project, max_batch=BATCHER_MAX,
                          max_delay_s=2e-3, registry=reg) as mb:
            def client(lo):
                for i in range(lo, BATCHER_REQUESTS, BATCHER_THREADS):
                    ts = time.perf_counter()
                    x = mb.submit(rows[i]).result(timeout=120)
                    with lock:
                        results[i] = x
                        lat.append(time.perf_counter() - ts)
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(BATCHER_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        add_launches(launches, counts)
        got = torch.stack([results[i] for i in range(BATCHER_REQUESTS)])
        t0 = time.perf_counter()
        alone = torch.cat([proj.project(rows[i:i + 1])
                           for i in range(BATCHER_REQUESTS)])
        torch.cuda.synchronize()
        t_alone = time.perf_counter() - t0
        _, err = scaled_err(got, alone)
        res_diff = (fold_residual(proj, rows, got)
                    - fold_residual(proj, rows, alone)).abs().max().item()
        stats = mb.stats
        h = next(x for x in reg.collect()
                 if x.name == "serve_batcher_batch_latency_s")
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        ok = (len(results) == BATCHER_REQUESTS and err <= SERVE_TOL["codes"]
              and res_diff <= SERVE_TOL["residual"]
              and stats.requests == BATCHER_REQUESTS
              and not any(t.is_alive() for t in threads))
        summary[algo] = {
            "wall_s": wall, "mean_batch": stats.mean_batch,
            "batches": stats.batches,
            "batch_p50_ms": h.quantile(0.5) * 1e3,
            "batch_p99_ms": h.quantile(0.99) * 1e3,
            "request_p50_ms": float(np.percentile(lat_ms, 50)),
            "request_p99_ms": float(np.percentile(lat_ms, 99)),
            "err": err, "residual_err": res_diff, "alone_s": t_alone}
        log(f"[batcher] {algo:4s} {BATCHER_REQUESTS} single-row requests "
            f"from {BATCHER_THREADS} threads in {wall:.2f} s: {stats.batches} "
            f"batches, mean batch {stats.mean_batch:.2f} (max "
            f"{stats.max_batch_seen}); registry batch latency p50 ≤ "
            f"{h.quantile(0.5) * 1e3:.1f} ms, p99 ≤ "
            f"{h.quantile(0.99) * 1e3:.1f} ms (bucket bounds); per request "
            f"p50 {summary[algo]['request_p50_ms']:.2f} ms, p99 "
            f"{summary[algo]['request_p99_ms']:.2f} ms; launches "
            f"{ {k: v for k, v in counts.items() if v} }; against each row "
            f"alone ({t_alone:.2f} s): codes {err:.2e} (tol "
            f"{SERVE_TOL['codes']:.0e}), rel residual {res_diff:.2e} (tol "
            f"{SERVE_TOL['residual']:.0e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"batcher {algo}: {len(results)} results, codes {err}, "
                    f"residual {res_diff}")
        del proj, got, alone
    os.environ[autotune.CACHE_ENV] = os.path.join(ROOT, "build",
                                                  "autotune.json")
    autotune.clear(memory_only=False)
    codes = FoldInProjector(art, algo="mu", max_batch=TOPK_QUERIES).project(
        A[-TOPK_QUERIES:])
    tuned = TopK(art, chunk=None)
    t0 = time.perf_counter()
    _, ti = tuned.query(codes, k=10)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    dv, di = TopK(art, chunk=4096).query(codes, k=10)
    entry = next(iter(autotune._load().values()))
    chosen = entry["params"][0]
    err, moved = topk_within_ties(tuned, codes, dv, di, ti)
    ok = err <= 1e-6
    log(f"[topk] TopK(chunk=None) over {art.W.shape[0]} rows, b = "
        f"{TOPK_QUERIES}, k = 10: chose chunk {chosen} "
        f"({entry['chosen_us']:.1f} µs) in a {t_search:.2f} s search; "
        f"candidates (µs) {entry['times_us']}; against chunk=4096's answer: "
        f"indices equal {torch.equal(ti, di)} ({moved} moved within ties), "
        f"score err {err:.2e} (tol 1e-06) {'ok' if ok else 'FAIL'}")
    require(ok, f"the tuned top-k disagrees with chunk=4096's: {err}")
    summary["topk"] = {"chosen": chosen, "times_us": entry["times_us"],
                       "search_s": t_search}
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[batcher] phase 21 took {summary['phase_s']:.1f} s")
    return launches, summary


def phase_mesh(A, res) -> tuple[dict, dict]:
    """Phase 22: ``MeshServer`` on a MESH_SHARDS-shard serve mesh of the
    one card and on one shard: its codes against the single-device
    projector's as phase 8b holds a served batch (SERVE_TOL: the codes
    scaled, both solutions' residuals ||a − xH|| / ||a||; 100 MU sweeps
    amplify the rounding of a differently summed R), its top-k on those codes against the
    single-device ``TopK``'s on the same codes (the same indices), and
    ``retrieve`` against the single-device project → TopK (each returned
    row scoring the single-device answer's score at its rank within 1e-5:
    rows whose scores tie within the codes' rounding may trade places),
    under shard="batch" and "features" and both merges; a served batch's
    launches (ts_matmul once per shard, the LUC once per shard per sweep);
    a hot swap under load losing no request; a stale swap refused; the
    p = MESH_SHARDS and p = 1 batch latency."""
    import threading
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.artifact import FactorArtifact
    from repro_torch.serve.foldin import FoldInProjector
    from repro_torch.serve.mesh import MeshServer, serve_mesh
    from repro_torch.serve.topk import TopK
    t_phase = time.perf_counter()
    dev = A.device
    art = FactorArtifact.from_result(res)
    rows = A[-MESH_BATCH:]
    single = FoldInProjector(art, max_batch=MESH_BATCH, iters=100)
    codes1 = single.project(rows)
    tk1 = TopK(art, chunk=4096)
    s1, i1 = tk1.query(codes1, k=10)
    launches, summary = {}, {}
    meshes = {MESH_SHARDS: serve_mesh(MESH_SHARDS, devices=[dev] * MESH_SHARDS),
              1: serve_mesh(1, devices=[dev])}
    for p, mesh in meshes.items():
        for shard in ("batch", "features"):
            for merge in (("tree", "gather") if p > 1 else ("auto",)):
                with MeshServer(art, mesh=mesh, shard=shard, merge=merge,
                                chunk=4096, max_batch=MESH_BATCH,
                                iters=100) as srv:
                    torch.cuda.synchronize()
                    ops.reset_launches()
                    t0 = time.perf_counter()
                    codes = srv.project(rows)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    counts = dict(ops.LAUNCHES)
                    add_launches(launches, counts)
                    _, cerr = scaled_err(codes, codes1)
                    res_diff = (fold_residual(single, rows, codes)
                                - fold_residual(single, rows, codes1)
                                ).abs().max().item()
                    qs, qi = srv.query(codes, k=10)
                    ws, wi = tk1.query(codes, k=10)
                    _, ri = srv.retrieve(rows, k=10)
                    qerr, qmoved = topk_within_ties(tk1, codes, ws, wi, qi)
                    rerr, moved = topk_within_ties(tk1, codes1, s1, i1, ri)
                    # one shard scans the single-device chunks: the same bits
                    exact = p > 1 or (torch.equal(qi, wi)
                                      and torch.equal(qs, ws))
                    ok = (cerr <= SERVE_TOL["codes"]
                          and res_diff <= SERVE_TOL["residual"]
                          and qerr <= 1e-6 and rerr <= 1e-5
                          and exact and counts["ts_matmul"] == p
                          and counts["mu_update"] == p * 100)
                    log(f"[mesh] p={p} shard={shard:8s} merge={merge:6s}: "
                        f"batch of {MESH_BATCH} in {ms:.2f} ms, launches "
                        f"{ {k: v for k, v in counts.items() if v} }; codes "
                        f"vs one device {cerr:.2e} (tol "
                        f"{SERVE_TOL['codes']:.0e}), rel residual "
                        f"{res_diff:.2e} (tol {SERVE_TOL['residual']:.0e}); "
                        f"top-k on the "
                        f"same codes vs one device: {qmoved} of {qi.numel()} "
                        f"rows moved within ties, score err {qerr:.2e} (tol "
                        f"1e-06){', bit-equal' if p == 1 and exact else ''}; "
                        f"retrieve vs one device's project → TopK: {moved} "
                        f"moved within ties, score err {rerr:.2e} (tol "
                        f"1e-05) {'ok' if ok else 'FAIL'}")
                    require(ok, f"mesh p={p} {shard}/{merge}: codes {cerr}, "
                                f"residual {res_diff}, "
                                f"top-k {qerr} (exact {exact}), retrieve "
                                f"{rerr}, launches {counts}")
                    summary[f"p{p}_{shard}_{merge}"] = {
                        "batch_ms": ms, "codes_err": cerr,
                        "residual_err": res_diff, "topk_err": qerr,
                        "topk_moved": qmoved, "retrieve_err": rerr,
                        "retrieve_moved": moved}
    # the served batch's latency, p shards against one, the same call
    lat = {}
    for p, mesh in meshes.items():
        proj = FoldInProjector(art.shard(mesh), max_batch=MESH_BATCH,
                               iters=100, mesh=mesh)
        lat[p] = time_ms(lambda: proj.project(rows), 5)
    log(f"[mesh] batch of {MESH_BATCH}, mu fold-in, 100 sweeps: p = "
        f"{MESH_SHARDS} {lat[MESH_SHARDS]:.2f} ms against p = 1 "
        f"{lat[1]:.2f} ms (CUDA events, 5 calls)")
    summary["batch_latency_ms"] = lat
    # a hot swap under load, then a stale swap
    newer = art.evolve()
    with MeshServer(art, mesh=meshes[MESH_SHARDS], chunk=4096,
                    max_batch=MESH_BATCH, iters=20) as srv:
        stop, errs, served = threading.Event(), [], [0]
        lock = threading.Lock()

        def client(i):
            while not stop.is_set():
                try:
                    srv.submit(rows[i]).result(timeout=120)
                except Exception as e:       # noqa: BLE001 — reported below
                    errs.append(e)
                    return
                with lock:
                    served[0] += 1

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        srv.swap(newer)
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        requests = srv.batcher.stats.requests
        refused = False
        try:
            srv.swap(art)
        except ValueError:
            refused = True
        ok = (not errs and served[0] == requests and srv.version == 1
              and refused and not any(t.is_alive() for t in threads))
        log(f"[mesh] hot swap under load: {served[0]} requests served of "
            f"{requests} submitted, version {srv.version}; stale swap "
            f"refused {refused} {'ok' if ok else 'FAIL'}")
        require(ok, f"mesh swap: errors {errs}, served {served[0]} of "
                    f"{requests}, refused {refused}")
    summary["swap_served"] = served[0]
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 22 took {summary['phase_s']:.1f} s")
    return launches, summary


# ---------------------------------------------------------------------------
# Phases 23–25: mixed operands (fault F2), the elastic runtime, OnlineNMF
# ---------------------------------------------------------------------------

#: phase 23: rows of the bf16 bpp fit held against backend="dense" on the
#: card (the dense backend's fp32 copy of a full-height bf16 A does not fit)
MIXED_DENSE_M = 253_344
#: a bf16 fit rounds W and H to bf16 after every step: a different fp32
#: summation order flips single bf16 roundings (2⁻⁸ relative), so fits are
#: held at a scaled 1e-2 (factors) and rtol 1e-3 (rel errors), as
#: tests/test_torch_mixed.py holds them against the JAX package
BF16_FIT_TOL = {"factors": 1e-2, "rel": 1e-3}
#: rows of A per chunk of the plain mixed products (a plain version widens
#: A to fp32: the whole of it would be 56 GB)
MIXED_CHUNK = 65_536
MIXED_SERVE_B = 64
#: phase 24
ELASTIC_ITERS, ELASTIC_SEG = 6, 2
ELASTIC_RULES = ("mu", "hals", "amu")
ELASTIC_OVERHEAD_ITERS, ELASTIC_OVERHEAD_SEGS = 10, (2, 10)
#: phase 25: the initial store, the batches, the refactor solver's cap
ONLINE_A0_ROWS, ONLINE_BATCH = 262_144, 4_096
ONLINE_NOISE = 0.01
ONLINE_BLOCKS, ONLINE_BLOCK_T, ONLINE_FULL_T = 8, 0.05, 0.5
#: the scripted stream: stream_batch rows (drift 0); "block": block 3's
#: columns tripled (excess in one block: a refresh); "spike": one value of
#: 10 a row in a random column (excess no nonnegative mix of H's rows
#: explains: a refactorization)
ONLINE_SCRIPT = ("clean", "clean", "block", "clean", "clean", "spike",
                 "clean", "clean", "block", "clean", "clean", "clean")
ONLINE_CLIENTS, ONLINE_SAMPLES = 4, 64
#: the top-k tile of the served retrievals: phase 21's tuned tile at 1M
#: rows (chunk=None would tune it again for every published version, on
#: the request path)
ONLINE_TOPK_CHUNK = 16_384


def mixed_plain(product: str, A, B):
    """The plain mixed product in row chunks of A (each widened to fp32 by
    ``kernels.ref``, as the whole of A cannot be)."""
    import torch
    from repro_torch.kernels import ref
    if product == "ts_matmul":
        return torch.cat([ref.ts_matmul(A[r0:r0 + MIXED_CHUNK], B)
                          for r0 in range(0, A.shape[0], MIXED_CHUNK)])
    out = torch.zeros((A.shape[1], B.shape[1]), dtype=torch.float32,
                      device=A.device)
    for r0 in range(0, A.shape[0], MIXED_CHUNK):
        out += ref.ts_matmul_t(A[r0:r0 + MIXED_CHUNK],
                               B[r0:r0 + MIXED_CHUNK])
    return out


def phase_mixed(dev, seed: int, m: int, n: int, errs: dict
                ) -> tuple[dict, dict, dict]:
    """Phase 23 (fault F2): Video's A in bf16 (28.0 GB), made after the fp32
    A is freed.  ``ts_matmul_t(A bf16, W fp32)`` and ``ts_matmul(A bf16,
    Hᵀ fp32)`` — the mixed instantiation — against their plain versions (in
    row chunks) at full height, against float64 on a 65,536-row slice and
    at a ragged shape, and against the fp32 kernel on the slice widened
    (bit for bit: a bf16 value's small tf32 part is 0); both timed beside
    the bytes bound and the chunked plain version.  Then one bpp iteration
    on ``backend="cuda"`` at full height (launches counted, the rel error
    against a direct ||A − WH|| / ||A||), the same fit at m = 253,344
    against ``backend="dense"`` on the card, and a bf16 request batch
    folded on fp32 factors (the served mixed product)."""
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.data.pipeline import lowrank_matrix
    from repro_torch.kernels import ops
    from repro_torch.serve.artifact import FactorArtifact
    from repro_torch.serve.foldin import FoldInProjector
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A = lowrank_matrix(gen, m, n, K, noise=NOISE, dtype=torch.bfloat16)
    Ht = torch.rand((n, K), generator=gen, device=dev)
    W = torch.rand((m, K), generator=gen, device=dev)
    torch.cuda.synchronize()
    log(f"[mixed] A {tuple(A.shape)} bf16 = {A.numel() * 2 / 1e9:.2f} GB "
        f"in {time.perf_counter() - t0:.2f} s; Hᵀ, W fp32")
    summary, timings, launches = {"checks": {}}, {}, {}
    gr = torch.Generator(device=dev).manual_seed(seed + 24)
    rm, rn, rk = RAGGED
    ragged = (torch.rand((rm, rn), generator=gr, device=dev).to(
        torch.bfloat16), torch.rand((rn, rk), generator=gr, device=dev),
        torch.rand((rm, rk), generator=gr, device=dev))
    rows = min(CHECK_ROWS, m)
    cases = {
        "ts_matmul": {"full": (A, Ht), "slice": (A[:rows], Ht),
                      "ragged": (ragged[0], ragged[1])},
        "ts_matmul_t": {"full": (A, W), "slice": (A[:rows], W[:rows]),
                        "ragged": (ragged[0], ragged[2])},
    }
    for product, by_case in cases.items():
        name = f"{product}_mixed"
        kern = getattr(ops, product)
        for case, (a, b) in by_case.items():
            got = kern(a, b)
            plain = mixed_plain(product, a, b)
            torch.cuda.synchronize()
            abs_err, err = scaled_err(got, plain)
            line = (f"[mixed] {name:17s} {case:6s} {tuple(a.shape)}·"
                    f"{tuple(b.shape)}: against the plain version {err:.3e}"
                    f" (tol {TOL['float32']:.0e})")
            ok = err <= TOL["float32"]
            rec = {"plain_err": err}
            if case != "full":
                a64 = a.double() if product == "ts_matmul" else a.double().T
                want = a64 @ b.double()
                f64, p64 = (scaled_err(x.double(), want)[1]
                            for x in (got, plain))
                same = torch.equal(got, kern(a.float(), b))
                line += (f", float64 {f64:.3e} (plain {p64:.3e}; tol "
                         f"{TOL['float32']:.0e}), the fp32 kernel on A "
                         f"widened bit for bit: {same}")
                ok = ok and f64 <= TOL["float32"]
                rec.update(f64_err=f64, plain_f64_err=p64, widened_equal=same)
                del a64, want
            log(line + f" {'ok' if ok else 'FAIL'}")
            require(ok, f"{name} {case} disagrees: {rec}")
            e = errs.setdefault(name, [0.0, 0.0])
            e[0], e[1] = max(e[0], abs_err), max(e[1], err)
            summary["checks"][f"{name} {case}"] = rec
            del got, plain
        torch.cuda.empty_cache()
    # times at full height, in turns: plain, kernel, kernel, plain
    f4, f2 = 4, 2
    for product, b, out_rows in (("ts_matmul", Ht, m), ("ts_matmul_t", W, n)):
        name = f"{product}_mixed"
        kern = getattr(ops, product)
        p1, k1, k2, p2 = (time_ms(f, 3) for f in (
            lambda: mixed_plain(product, A, b), lambda: kern(A, b),
            lambda: kern(A, b), lambda: mixed_plain(product, A, b)))
        rb = m * n * f2 + b.numel() * f4
        b_ms, b_by = bound_ms(rb, out_rows * K * f4, 2 * 2.0 * m * n * K,
                              "tf32")
        timings[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": None}
        log(f"[timings] {name:17s} bf16·fp32 kernel {k1:.3f}/{k2:.3f} ms, "
            f"plain (row chunks) {p1:.3f}/{p2:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by}: A's {m * n * f2 / 1e9:.2f} GB at 3.35 TB/s); no single "
            f"PyTorch call takes a bf16 A beside an fp32 B without an fp32 "
            f"copy of A; {(rb + out_rows * K * f4) / (min(k1, k2) * 1e-3) / 1e9:.0f}"
            f" GB/s")
    del W, Ht, ragged
    torch.cuda.empty_cache()
    # one bpp iteration at full height on backend="cuda"
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = NMFSolver(K, algo="bpp", max_iters=1).fit(A, seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    add_launches(launches, counts)
    want = dict.fromkeys(counts, 0)
    want.update(gram=3, ts_matmul=1, ts_matmul_t_mixed=1)
    direct = direct_rel_error(A, res.W, res.H)
    rel = float(res.rel_errors[-1])
    ok = (counts == want and res.W.dtype == torch.bfloat16
          and bool(torch.isfinite(res.W.float()).all()
                   and torch.isfinite(res.H.float()).all())
          and abs(direct - rel) <= 1e-2 * direct)
    log(f"[mixed] bpp 1 iter, bf16 A at {tuple(A.shape)} on cuda: fit "
        f"{wall:.2f} s incl. set-up; launches "
        f"{ {k: v for k, v in counts.items() if v} }; rel error {rel:.6f}, "
        f"direct {direct:.6f} {'ok' if ok else 'FAIL'}")
    require(ok, f"bf16 bpp on cuda: launches {counts} (want {want}), rel "
                f"{rel} against direct {direct}")
    summary["bpp_full"] = {"s": wall, "rel": rel, "direct": direct}
    # a bf16 request batch on fp32 factors: the served mixed product
    art = FactorArtifact.from_factors(res.W.float(), res.H.float(),
                                      algo="mu")
    proj = FoldInProjector(art, iters=100)
    req = A[:MIXED_SERVE_B].contiguous()
    proj.project(req)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    codes = proj.project(req)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(ops.LAUNCHES)
    add_launches(launches, counts)
    widened = proj.project(req.float())
    torch.cuda.synchronize()
    same = torch.equal(codes, widened)
    _, err = scaled_err(codes, widened)
    ok = (counts["ts_matmul_mixed"] == 1 and counts["ts_matmul"] == 0
          and err <= SERVE_TOL["codes"])
    log(f"[mixed] a bf16 batch of {MIXED_SERVE_B} rows on fp32 factors (mu, "
        f"100 sweeps): {ms:.3f} ms, launches "
        f"{ {k: v for k, v in counts.items() if v} }; codes against the "
        f"batch widened to fp32: {err:.2e} (tol {SERVE_TOL['codes']:.0e}), "
        f"bit for bit {same} {'ok' if ok else 'FAIL'}")
    require(ok, f"bf16 batch on fp32 factors: launches {counts}, err {err}")
    summary["serve"] = {"ms": ms, "bit_equal_widened": same}
    del res, art, proj, req, codes, widened
    torch.cuda.empty_cache()
    # at m = 253,344: cuda against dense (the dense backend widens A)
    Ad = A[:MIXED_DENSE_M]
    fits = {}
    ops.reset_launches()
    for backend in ("cuda", "dense"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits[backend] = NMFSolver(K, algo="bpp", max_iters=1,
                                  backend=backend).fit(Ad, seed=seed)
        torch.cuda.synchronize()
        fits[backend + "_s"] = time.perf_counter() - t0
    add_launches(launches, ops.LAUNCHES)
    f_err = max(scaled_err(fits["cuda"].W.float(), fits["dense"].W.float())[1],
                scaled_err(fits["cuda"].H.float(), fits["dense"].H.float())[1])
    r_c, r_d = (float(fits[b].rel_errors[-1]) for b in ("cuda", "dense"))
    ok = (f_err <= BF16_FIT_TOL["factors"]
          and abs(r_c - r_d) <= BF16_FIT_TOL["rel"] * r_d)
    log(f"[mixed] bpp 1 iter at m = {MIXED_DENSE_M}: cuda "
        f"{fits['cuda_s']:.2f} s, dense {fits['dense_s']:.2f} s; factors "
        f"{f_err:.2e} apart (scaled, tol {BF16_FIT_TOL['factors']:.0e}), rel "
        f"errors {r_c:.6f} / {r_d:.6f} (rtol {BF16_FIT_TOL['rel']:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"bf16 bpp cuda vs dense at m={MIXED_DENSE_M}: factors "
                f"{f_err}, rels {r_c} {r_d}")
    summary["cuda_vs_dense"] = {"factors": f_err, "rel_cuda": r_c,
                                "rel_dense": r_d}
    del fits, Ad, A
    torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[mixed] phase 23 took {summary['phase_s']:.1f} s")
    return launches, summary, timings


def _same_fit(res, ref) -> bool:
    import torch
    same = (torch.equal(res.W, ref.W) and torch.equal(res.H, ref.H)
            and torch.equal(res.rel_errors, ref.rel_errors)
            and res.iters == ref.iters
            and res.extras["rule_state"] == ref.extras["rule_state"])
    mine, theirs = (r.extras.get("panel_residuals") for r in (res, ref))
    if mine is not None or theirs is not None:
        same = same and mine.keys() == theirs.keys() and all(
            torch.equal(mine[key], theirs[key]) for key in mine)
    return same


def _elastic_solver(algo: str, iters: int, **kw):
    from repro_torch.core import rules
    from repro_torch.core.engine import NMFSolver
    rule = (type(rules.get_rule(algo))(inner_iters=4, delta=0.01)
            if algo in ("amu", "ahals") else algo)
    return NMFSolver(K, algo=rule, max_iters=iters, **kw)


def _kill_resume(A, seed: int, mk, ckdir: str, crashes, fault=None):
    """The elastic run of ``mk()`` killed after the checkpoint at each step
    of ``crashes`` (``fault``: a storage fault at the last one too) and
    resumed, to its end; returns (result, the last runner, the restore
    seconds of each resume)."""
    from repro_torch.elastic import ElasticRunner, FaultPlan, InjectedFault
    from repro_torch.obs.trace import Tracer
    import shutil
    shutil.rmtree(ckdir, ignore_errors=True)
    restores = []
    for i, at in enumerate(crashes):
        extra = ({f"{fault}_at": (at,)} if fault and i == len(crashes) - 1
                 else {})
        tracer = Tracer()
        try:
            ElasticRunner(mk(), ckdir, segment_iters=ELASTIC_SEG,
                          fault_plan=FaultPlan(crash_at=(at,), **extra),
                          tracer=tracer).fit(A, seed=seed)
        except InjectedFault:
            pass
        else:
            raise RuntimeError(f"chip_smoke: no crash at step {at}")
        restores += [s.dur_us / 1e6 for s in tracer.spans()
                     if s.name == "elastic.restore"]
    tracer = Tracer()
    runner = ElasticRunner(mk(), ckdir, segment_iters=ELASTIC_SEG,
                           tracer=tracer)
    res = runner.fit(A)
    restores += [s.dur_us / 1e6 for s in tracer.spans()
                 if s.name == "elastic.restore"]
    return res, runner, restores


def phase_elastic(A, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 24, on the fp32 Video A (k = 50, ``backend="cuda"``): for mu,
    hals and amu (inner_iters=4, delta=0.01: a rule state), 6 iterations in
    segments of 2, killed after the checkpoints at steps 2 and 4 and
    resumed to the end: W, H, the rel errors and the rule state bit-equal
    to ``fit(max_iters=6)`` from the same seed.  mu again with the newest
    payload corrupted (the run resumes from the one before it, bit-equal).
    int8 faun mu on a one-rank NCCL group killed at step 2 and resumed:
    bit-equal, residuals restored.  A serial checkpoint resumed as faun
    1×1 on NCCL: bit-equal to serial's uninterrupted fit.  Then the
    per-save blocking seconds, write and restore seconds, and the
    segmented run's overhead over the unsegmented fit at segment_iters 2
    and 10."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.faun import make_faun_grid
    from repro_torch.elastic import ElasticRunner, remesh_solver
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "elastic")
    launches, summary = {}, {"resume": {}}
    refs = {}
    for algo in ELASTIC_RULES:
        ops.reset_launches()
        refs[algo] = ref = _elastic_solver(algo, ELASTIC_ITERS).fit(
            A, seed=seed)
        add_launches(launches, ops.LAUNCHES)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, runner, restores = _kill_resume(
            A, seed, lambda: _elastic_solver(algo, ELASTIC_ITERS),
            os.path.join(root, algo), (2, 4))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add_launches(launches, ops.LAUNCHES)
        same = _same_fit(res, ref)
        log(f"[elastic] {algo:4s} {ELASTIC_ITERS} iters in segments of "
            f"{ELASTIC_SEG}, killed at steps 2 and 4, resumed twice in "
            f"{wall:.2f} s (restores {', '.join(f'{r:.2f}' for r in restores)}"
            f" s): bit-equal to fit() {same}; rule state "
            f"{res.extras['rule_state']} {'ok' if same else 'FAIL'}")
        require(same, f"elastic {algo}: the resumed run is not bit-equal")
        summary["resume"][algo] = {"s": wall, "restore_s": restores}
        del res
    # the newest payload corrupted: the run resumes from the one before it
    res, runner, _ = _kill_resume(
        A, seed, lambda: _elastic_solver("mu", ELASTIC_ITERS),
        os.path.join(root, "corrupt"), (4,), fault="corrupt")
    same = _same_fit(res, refs["mu"]) and runner.corrupt_payloads.value == 1
    log(f"[elastic] mu with the step-4 payload corrupted: skipped "
        f"({int(runner.corrupt_payloads.value)} corrupt), resumed from step 2, "
        f"bit-equal {same} {'ok' if same else 'FAIL'}")
    require(same, "elastic: the corrupt-payload fallback is not bit-equal")
    del res
    with nccl_group():
        grid = make_faun_grid(1, 1)
        mk = lambda: _elastic_solver("mu", ELASTIC_ITERS, schedule="faun",
                                     grid=grid, panel_compression="int8")
        ref8 = mk().fit(A, seed=seed)
        res, runner, _ = _kill_resume(A, seed, mk, os.path.join(root, "int8"),
                                      (2,))
        arrays, _ = ckpt.read_payload(os.path.join(root, "int8",
                                                   "step_00000002"))
        stacked = {k: tuple(v.shape) for k, v in arrays.items()
                   if k.startswith("res::")}
        same = (_same_fit(res, ref8) and runner.residual_reinits.value == 0
                and stacked["res::gather_w"] == (1, 1, A.shape[0], K))
        log(f"[elastic] int8 faun 1×1 mu on NCCL killed at step 2: residuals "
            f"restored in the stacked layout {stacked['res::rs_w']} "
            f"(rs_w), bit-equal with its residuals {same} "
            f"{'ok' if same else 'FAIL'}")
        require(same, "elastic: int8 faun resume is not bit-equal")
        del res, ref8
        # a serial checkpoint resumed as faun 1×1
        d = os.path.join(root, "remesh")
        shutil.rmtree(d, ignore_errors=True)
        serial = _elastic_solver("mu", ELASTIC_ITERS)
        ElasticRunner(serial, d, segment_iters=ELASTIC_SEG).fit(
            A, seed=seed, max_iters=2)
        runner = ElasticRunner(remesh_solver(serial, schedule="faun",
                                             grid=grid), d,
                               segment_iters=ELASTIC_SEG)
        res = runner.fit(A)
        same = (_same_fit(res, refs["mu"]) and runner.restores.value == 1)
        log(f"[elastic] a serial checkpoint (step 2) resumed as faun 1×1 on "
            f"NCCL: bit-equal to serial's uninterrupted fit {same} "
            f"{'ok' if same else 'FAIL'}")
        require(same, "elastic: serial → faun 1×1 is not bit-equal")
        del res
    del refs
    # the price of checkpointing: the unsegmented fit against the runner
    over = {}
    solver = _elastic_solver("mu", ELASTIC_OVERHEAD_ITERS)
    solver.fit(A, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.fit(A, seed=seed)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for seg in ELASTIC_OVERHEAD_SEGS:
        d = os.path.join(root, f"overhead_{seg}")
        shutil.rmtree(d, ignore_errors=True)
        runner = ElasticRunner(solver, d, segment_iters=seg, keep_last=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.fit(A, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = runner.ckpt_block_seconds
        over[seg] = {"s": wall, "plain_s": plain_s,
                     "overhead": wall / plain_s - 1, "saves": h.count,
                     "block_s_mean": h.sum / max(h.count, 1),
                     "block_s_max": h.max}
        log(f"[elastic] mu {ELASTIC_OVERHEAD_ITERS} iters, segment_iters "
            f"{seg}: {wall:.3f} s against fit() {plain_s:.3f} s "
            f"(+{100 * (wall / plain_s - 1):.1f} %); {h.count} saves "
            f"blocking {h.sum / max(h.count, 1) * 1e3:.1f} ms each on "
            f"average, {h.max * 1e3:.1f} at most (host copy + joining the "
            f"previous write)")
    # one synchronous save, and a restore, timed on their own
    d = os.path.join(root, "sync")
    shutil.rmtree(d, ignore_errors=True)
    from repro_torch.elastic import FaultPlan
    runner = ElasticRunner(solver, d, segment_iters=2, fault_plan=FaultPlan())
    runner.fit(A, seed=seed, max_iters=2)
    write_s = runner.ckpt_block_seconds.sum
    size = os.path.getsize(os.path.join(d, "step_00000002", "arrays.npz"))
    from repro_torch.obs.trace import Tracer
    tracer = Tracer()
    ElasticRunner(solver, d, segment_iters=2, tracer=tracer).fit(
        A, max_iters=2)
    restore_s = [s.dur_us / 1e6 for s in tracer.spans()
                 if s.name == "elastic.restore"][0]
    log(f"[elastic] a synchronous save (host copy + write of "
        f"{size / 1e6:.1f} MB) {write_s:.3f} s; a restore (scan, read, "
        f"verify, prepare) {restore_s:.3f} s; card {card}")
    summary.update(overhead=over, write_s=write_s, restore_s=restore_s,
                   mb=size / 1e6)
    shutil.rmtree(root, ignore_errors=True)
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[elastic] phase 24 took {summary['phase_s']:.1f} s")
    return launches, summary


def online_batch(seed: int, step: int, kind: str):
    """One batch of phase 25's scripted stream (ONLINE_SCRIPT)."""
    import torch
    from repro_torch.data.pipeline import stream_batch
    from repro_torch.online import block_slices
    rows = stream_batch(seed, step, rows=ONLINE_BATCH, n=N_FULL, k=K,
                        noise=ONLINE_NOISE)
    if kind == "block":
        sl = block_slices(N_FULL, ONLINE_BLOCKS)[3]
        rows[:, sl] *= 3.0
    elif kind == "spike":
        gen = torch.Generator(device=rows.device).manual_seed(seed + step)
        cols = torch.randint(0, N_FULL, (ONLINE_BATCH,), generator=gen,
                             device=rows.device)
        rows.zero_()
        rows[torch.arange(ONLINE_BATCH, device=rows.device), cols] = 10.0
    return rows


def _online_service(A0, res):
    from repro_torch.online import OnlineNMF
    return OnlineNMF(A0, k=K, algo="hals", result=res,
                     max_batch=ONLINE_BATCH, chunk=ONLINE_TOPK_CHUNK,
                     n_blocks=ONLINE_BLOCKS,
                     block_threshold=ONLINE_BLOCK_T,
                     full_threshold=ONLINE_FULL_T)


def phase_online(dev, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 25: ``OnlineNMF`` at Video's width (n = 13,824, k = 50, hals on
    ``cuda``): A0 = 262,144 rows of ``stream_batch`` (14.5 GB), the initial
    fit 10 iterations, passed as ``result=``; then 12 batches of 4,096 rows
    (ONLINE_SCRIPT).  A first, quiet pass counts each ingest's launches and
    times it (synchronised), holds a refresh's untouched H columns bit-equal
    and checks the store is never copied; a second pass ingests the same
    stream while four client threads ``submit`` single rows and
    ``retrieve`` top-10: it must take the same actions, every stamp ≤ the
    latest version, and 64 sampled responses must match a cold fold on
    their version's artifact (SERVE_TOL).  The staleness share, the peak
    memory over the final store, and rel_err against a from-scratch fit
    of the accumulated matrix are reported."""
    import random
    import threading
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.data.pipeline import stream_batch
    from repro_torch.kernels import ops
    from repro_torch.online import block_slices
    from repro_torch.serve.foldin import FoldInProjector
    t_phase = time.perf_counter()
    A0 = stream_batch(seed, 0, rows=ONLINE_A0_ROWS, n=N_FULL, k=K,
                      noise=ONLINE_NOISE)
    launches, summary = {}, {}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = NMFSolver(K, algo="hals", max_iters=10).fit(A0, seed=seed)
    torch.cuda.synchronize()
    add_launches(launches, ops.LAUNCHES)
    log(f"[online] A0 {tuple(A0.shape)} fp32 "
        f"{A0.numel() * 4 / 1e9:.2f} GB; initial hals fit, 10 iters, "
        f"{time.perf_counter() - t0:.2f} s, rel error "
        f"{float(res.rel_errors[-1]):.6f}")
    batches = [online_batch(seed, step, kind)
               for step, kind in enumerate(ONLINE_SCRIPT, 1)]
    # the quiet pass: launches, times and the store
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc = _online_service(A0, res)
    buf = svc.A.data_ptr()
    per_action, actions = {}, []
    for rows in batches:
        H_before = svc.H
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = svc.ingest(rows)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in ops.LAUNCHES.items() if v}
        add_launches(launches, counts)
        actions.append(rep.action)
        row = per_action.setdefault(rep.action, {"ms": [], "launches": []})
        row["ms"].append(ms)
        row["launches"].append(counts)
        if rep.action == "refresh":
            mask = torch.zeros(N_FULL, dtype=torch.bool, device=dev)
            for b in rep.touched_blocks:
                mask[block_slices(N_FULL, ONLINE_BLOCKS)[b]] = True
            kept = torch.equal(svc.H[:, ~mask], H_before[:, ~mask])
            require(kept, "online: a refresh changed untouched H columns")
            row.setdefault("touched", []).append(rep.touched_blocks)
        log(f"[online] v{rep.version} {rep.action:8s} {ms:9.2f} ms, drift "
            f"{rep.drift_total:.4f}, touched {rep.touched_blocks}, launches "
            f"{counts}")
        del H_before
    peak = torch.cuda.max_memory_allocated()
    # the store's buffers, and the phase's own inputs: A0 and the batches
    store = svc._A.buf.numel() * 4 + svc._W.buf.numel() * 4
    inputs = (A0.numel() + sum(b.numel() for b in batches)) * 4
    same_buf = svc.A.data_ptr() == buf
    require(same_buf, "online: an ingest copied the store")
    require({"extend", "refresh", "refactor"} <= set(actions),
            f"online: the stream took only {set(actions)}")
    online_rel = svc.rel_err()
    m_total = svc.shape[0]
    A_acc = svc.A
    scratch = NMFSolver(K, algo="hals", max_iters=30, tol=1e-5).fit(
        A_acc, seed=seed)
    scratch_rel = direct_rel_error(A_acc, scratch.W, scratch.H)
    ok = online_rel <= 2.0 * scratch_rel + 0.05
    log(f"[online] quiet pass: actions {actions}; store {m_total} rows, "
        f"never copied ({same_buf}); peak {peak / 1e9:.2f} GB: the store's "
        f"buffers {store / 1e9:.2f}, A0 and the batches {inputs / 1e9:.2f}, "
        f"{(peak - store - inputs) / 1e9:.2f} GB over them; rel_err "
        f"{online_rel:.6f} against a from-scratch fit (hals, 30 iters, tol "
        f"1e-5) {scratch_rel:.6f} {'ok' if ok else 'FAIL'}")
    require(ok, f"online rel_err {online_rel} outside 2 × {scratch_rel} + "
                f"0.05")
    summary["quiet"] = {"actions": actions, "per_action": {
        a: {"ms": v["ms"], "launches": v["launches"]}
        for a, v in per_action.items()},
        "peak_gb": peak / 1e9, "store_gb": store / 1e9,
        "peak_over_store_and_inputs_gb": (peak - store - inputs) / 1e9,
        "rel_err": online_rel,
        "scratch_rel_err": scratch_rel}
    svc.close()
    del svc, scratch, A_acc
    torch.cuda.empty_cache()
    # the live pass: four clients during ingest
    probes = stream_batch(seed, 99, rows=ONLINE_CLIENTS, n=N_FULL, k=K,
                          noise=ONLINE_NOISE)
    svc = _online_service(A0, res)
    del A0
    arts = {0: svc.artifact}
    results, errors = [], []
    stop = threading.Event()
    lock = threading.Lock()

    def client(tid):
        try:
            futs, got = [], []
            while not stop.is_set():
                futs.append(svc.submit(probes[tid]))
                if len(futs) % 8 == 0:
                    _, idx, v = svc.retrieve(probes[tid:tid + 1], k=10)
                    got.append(("retrieve", v, tuple(idx.shape)))
                time.sleep(0.002)
            got += [("submit", f.result(timeout=120)) for f in futs]
            with lock:
                results.extend((tid,) + g for g in got)
        except Exception as e:                    # reported after join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(ONLINE_CLIENTS)]
    for t in threads:
        t.start()
    live = []
    t0 = time.perf_counter()
    try:
        for rows in batches:
            rep = svc.ingest(rows)
            live.append(rep.action)
            arts[rep.version] = svc.artifact
    finally:                     # a failed ingest must not leave them running
        stop.set()
        ingest_s = time.perf_counter() - t0
        for t in threads:
            t.join(timeout=300)
    require(not any(t.is_alive() for t in threads), "online: a client hung")
    require(not errors, f"online: a client failed: {errors[:1]}")
    latest = svc.version
    staleness = svc.stats.staleness
    served = [r for r in results if r[1] == "submit"]
    stamps_ok = all(r[2].version <= latest for r in served) and all(
        r[2] <= latest and r[3] == (1, 10) for r in results
        if r[1] == "retrieve")
    random.seed(seed)
    sample = random.sample(served, min(ONLINE_SAMPLES, len(served)))
    cold = {}
    worst = 0.0
    for tid, _, r in sample:
        if r.version not in cold:
            cold[r.version] = FoldInProjector(arts[r.version]).project(
                probes)
        worst = max(worst, scaled_err(r.code.to(dev),
                                      cold[r.version][tid])[1])
    ok = (live == actions and stamps_ok and worst <= SERVE_TOL["codes"]
          and len(served) >= ONLINE_SAMPLES)
    log(f"[online] live pass: {len(served)} single-row responses and "
        f"{len(results) - len(served)} top-10 retrievals from "
        f"{ONLINE_CLIENTS} clients during {ingest_s:.2f} s of ingest; the "
        f"same actions {live == actions}; every stamp ≤ v{latest} "
        f"{stamps_ok}; staleness {staleness:.4f}; {len(sample)} sampled "
        f"codes against a cold fold on their version: {worst:.2e} (tol "
        f"{SERVE_TOL['codes']:.0e}) {'ok' if ok else 'FAIL'}; card {card}")
    require(ok, f"online live pass: actions {live} vs {actions}, stamps "
                f"{stamps_ok}, codes {worst}, served {len(served)}")
    summary["live"] = {"served": len(served), "staleness": staleness,
                       "ingest_s": ingest_s, "codes_err": worst,
                       "versions": sorted({r[2].version for r in served})}
    svc.close()
    del svc, arts, cold, res, batches
    torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[online] phase 25 took {summary['phase_s']:.1f} s")
    return launches, summary


# ----------------------------------------------------------------------------
# Phases 26–28: the model stack (models/, configs/) and NMF weight compression

#: a decode step against the full forward at the same position, max |Δ| over
#: max |forward| (tests/test_decode.py's bound), in fp32
DECODE_TOL = 5e-3
#: the fp32 blockwise prefill (chunked online softmax) against the dense
#: forward of the same weights, scaled
BLOCKWISE_TOL = 1e-4
#: bf16 serving: a decode step's logits no further from the fp32 forward of
#: the same weights (upcast) than BF16_FACTOR times the bf16 forward's own
#: distance from it, measured in the same run
BF16_FACTOR = 3.0
SMOLLM = ("smollm_135m", 8, 2_048, 32)          # arch, batch, prompt, steps
CHECK_STEPS = 4
#: full width, depth cut: arch -> (config overrides, batch, prompt, encoder
#: frames, why).  attn_chunk is cut where the prompt (or Whisper's 1,500
#: frames) is no multiple of 1,024: the blockwise path needs S % chunk = 0.
FULL_WIDTH_CUTS = {
    "recurrentgemma_9b": ({"n_layers": 3, "attn_chunk": 500}, 1, 2_500, 0,
                          "one pattern group (rglru, rglru, local_attn) of "
                          "38 layers; attn_chunk 1,024 -> 500 (2,500 = 5 x "
                          "500); prompt 2,500 > W = 2,048, no multiple"),
    "dbrx_132b": ({"n_layers": 2}, 1, 512, 0,
                  "2 of 40 layers; no-drop capacity (capacity_factor 16)"),
    "xlstm_125m": ({}, 2, 1_000, 0,
                   "none (all 12 layers); prompt 1,000 against mlstm_chunk "
                   "256 (ragged)"),
    "whisper_base": ({"attn_chunk": 500}, 2, 64, 1_500,
                     "none (6 + 6 layers); attn_chunk 1,024 -> 500 for "
                     "1,500 encoder frames (3 x 500)"),
}
WC_KS = (4, 8, 16, 32)
WC_ITERS = 30
WC_CHECK_KS = (4, 32)
#: the weight-compression fit on cuda against backend="dense" from the same
#: W0/H0: last rel error, relative
WC_REL_TOL = 1e-3


def nodrop(cfg):
    """No-drop capacity (tests/test_decode.py's ``_nodrop``): a full
    forward and incremental decode then route every token alike."""
    if cfg.moe.n_experts:
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    return cfg


def model_batch(cfg, gen, B: int, S: int, enc_len: int = 0) -> dict:
    """Random tokens and modality stubs on the generator's device."""
    import torch
    dev = gen.device
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=dev)}
    if cfg.is_encdec:
        batch["enc_frames"] = 0.1 * torch.randn(
            (B, enc_len or S, cfg.d_model), generator=gen, device=dev)
    if cfg.frontend == "image_patches":
        batch["img_embeds"] = 0.1 * torch.randn(
            (B, cfg.num_image_tokens, cfg.d_model), generator=gen,
            device=dev)
    return batch


def twin(model, cfg):
    """An ``LM`` of ``cfg`` on ``model``'s weights: shared where the dtype
    is the same, upcast copies otherwise."""
    import torch
    from repro_torch.models.lm import LM
    dt = cfg.param_dtype_torch
    params = torch.utils._pytree.tree_map(
        lambda t: t if t.dtype == torch.float32 else t.to(dt), model.tree())
    return LM(cfg, device=model.device, params=params)


def fp32_cfg(cfg):
    return cfg.replace(param_dtype="float32", dtype="float32")


def decode_errs(model, batch, P: int, full) -> list:
    """Prefill P tokens, decode the rest of ``batch`` one by one, each
    step's logits against ``full`` (B, S, V) at its position, scaled."""
    import torch
    S = batch["tokens"].shape[1]
    pre = dict(batch, tokens=batch["tokens"][:, :P])
    _, caches = model.prefill(pre, kv_len=S)
    errs = []
    for t in range(P, S):
        dl, caches = model.decode_step(caches, batch["tokens"][:, t:t + 1], t)
        errs.append(scaled_err(dl[:, 0], full[:, t])[1])
    del caches
    torch.cuda.synchronize()
    return errs


def phase_models_reduced(dev, seed: int) -> dict:
    """Phase 26: every architecture at its reduced config, fp32."""
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.models.lm import LM
    t_phase = time.perf_counter()
    out = {}
    for arch in cb.ARCH_IDS:
        cfg = nodrop(cb.get_reduced_config(arch))
        model = LM(cfg, device=dev, seed=seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        B, P = 2, 32
        batch = model_batch(cfg, gen, B, P + 3)
        with torch.inference_mode():
            full, _, aux = model(batch)
        require(tuple(full.shape) == (B, P + 3, cfg.vocab)
                and full.dtype == torch.float32,
                f"{arch}: logits {tuple(full.shape)} {full.dtype}")
        require(bool(torch.isfinite(full).all()) and bool(torch.isfinite(aux)),
                f"{arch}: the forward is not finite")
        errs = decode_errs(model, batch, P, full)
        ok = max(errs) <= DECODE_TOL
        log(f"[models] {arch:20s} reduced fp32: logits {tuple(full.shape)} "
            f"finite, {model.param_count()} params; decode vs forward "
            f"{', '.join(f'{e:.2e}' for e in errs)} (tol {DECODE_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{arch}: decode disagrees with the full forward")
        out[arch] = {"params": model.param_count(), "decode_err": max(errs)}
    # the reference's ring caveat: a local-attention prompt longer than the
    # window and no multiple of it
    cfg = cb.get_reduced_config("recurrentgemma_9b")
    model = LM(cfg, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for P in (40, 70):
        batch = model_batch(cfg, gen, 2, P + 3)
        with torch.inference_mode():
            full, _, _ = model(batch)
        errs = decode_errs(model, batch, P, full)
        ok = max(errs) <= DECODE_TOL
        log(f"[models] recurrentgemma reduced, prompt {P} (W = {cfg.window}, "
            f"{P} mod W = {P % cfg.window}): decode vs forward "
            f"{', '.join(f'{e:.2e}' for e in errs)} {'ok' if ok else 'FAIL'}")
        require(ok, f"the ring at prompt {P} disagrees with the forward")
        out[f"ring_p{P}"] = max(errs)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[models] phase 26 took {out['phase_s']:.1f} s")
    return out


def phase_decode_profile(dev, seed: int, decode_ms: float) -> dict:
    """The kernels and device time of one smollm-135m decode step (phase
    27's model, batch and cache, rebuilt from the seed), from
    ``torch.profiler``; None where the profiler records no device work.
    It runs last: after a profiler session every launch of the process
    costs about twice the host time (tools/probe_profiler_overhead.py)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import base as cb
    from repro_torch.models.lm import LM
    arch, B, P, steps = SMOLLM
    cfg = cb.get_config(arch)
    model = LM(cfg, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    fed, _, _, _, caches, token = greedy(model, prompt, steps, 0)
    pos = P + steps - 1
    del fed
    # the last step again, on its own cache slot
    model.decode_step(caches, token, pos)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(caches, token, pos)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy_us = sum(getattr(e, "device_time", None)
                      or getattr(e, "cuda_time", 0.0) for e in kernels)
    except (RuntimeError, AttributeError) as exc:
        log(f"[serve] decode profile not measured: {exc}")
        kernels = []
    out = {"decode_step_kernels": len(kernels) or None,
           "decode_step_device_ms": busy_us / 1e3 if kernels else None}
    idle = (None if out["decode_step_device_ms"] is None
            else 1 - out["decode_step_device_ms"] / decode_ms)
    out["decode_idle_share"] = idle
    log(f"[serve] one smollm-135m decode step ({B} x 1, cache "
        f"{P + steps}): {out['decode_step_kernels']} kernels, "
        f"{out['decode_step_device_ms']} ms on the device, "
        f"{'not measured' if idle is None else format(idle, '.1%')} idle "
        f"against phase 27's {decode_ms:.3f} ms per step")
    return out


def full_width_check(label: str, model, cfg, batch, P: int, dec_logits,
                     prefill_logits=None) -> dict:
    """Hold a bf16 model's decode logits (positions P.. of ``batch``)
    against the fp32 forward of the same weights (BF16_FACTOR × the bf16
    forward's own distance), its fp32 twin's decode against that forward
    (DECODE_TOL) and the fp32 twin's prefill, blockwise where the config
    is, against it (BLOCKWISE_TOL)."""
    import torch
    n = dec_logits.shape[1]
    sl = slice(P, P + n)
    dense = cfg.replace(attn_chunk=0)
    with torch.inference_mode():
        f16 = twin(model, dense)(batch)[0][:, sl].clone()
        m32 = twin(model, fp32_cfg(dense))
        full32 = m32(batch)[0]
        f32 = full32[:, sl].clone()
        e16 = scaled_err(f16, f32)[1]
        e_dec16 = scaled_err(dec_logits, f32)[1]
        e_dec_fwd16 = scaled_err(dec_logits, f16)[1]
        del f16
        m32 = twin(m32, fp32_cfg(cfg))      # its own chunks, the same tensors
        pre = dict(batch, tokens=batch["tokens"][:, :P])
        p32, caches = m32.prefill(pre, kv_len=P + n)
        e_pre = scaled_err(p32, full32[:, :P])[1]
        del p32, full32
        errs32 = []
        for i in range(n):
            t = P + i
            dl, caches = m32.decode_step(caches, batch["tokens"][:, t:t + 1], t)
            errs32.append(scaled_err(dl[:, 0], f32[:, i])[1])
    del caches, m32
    torch.cuda.empty_cache()
    tol16 = BF16_FACTOR * e16
    ok16, ok32 = e_dec16 <= tol16, max(errs32) <= DECODE_TOL
    ok_pre = e_pre <= BLOCKWISE_TOL
    log(f"[serve] {label}: bf16 forward vs fp32 forward {e16:.3e}; bf16 "
        f"decode vs fp32 forward {e_dec16:.3e} (tol {BF16_FACTOR:g} x "
        f"{e16:.3e} = {tol16:.3e}) {'ok' if ok16 else 'FAIL'}, vs the bf16 "
        f"forward {e_dec_fwd16:.3e}; fp32 decode vs fp32 forward "
        f"{', '.join(f'{e:.2e}' for e in errs32)} (tol {DECODE_TOL:.0e}) "
        f"{'ok' if ok32 else 'FAIL'}; fp32 prefill "
        f"(attn_chunk {cfg.attn_chunk}) vs the dense forward {e_pre:.2e} "
        f"(tol {BLOCKWISE_TOL:.0e}) {'ok' if ok_pre else 'FAIL'}")
    require(ok16, f"{label}: bf16 decode beyond the bf16 tolerance")
    require(ok32, f"{label}: fp32 decode disagrees with the forward")
    require(ok_pre, f"{label}: the prefill disagrees with the dense forward")
    return {"bf16_fwd_vs_fp32": e16, "bf16_decode_vs_fp32": e_dec16,
            "bf16_decode_vs_bf16_fwd": e_dec_fwd16,
            "fp32_decode_vs_fp32": max(errs32), "fp32_prefill_vs_dense": e_pre}


def greedy(model, prompt, steps: int, keep: int):
    """Prefill, then ``steps`` greedy decode steps as ``make_serve_step``
    does inline: (tokens fed (B, steps), the first ``keep`` steps' logits,
    prefill ms, decode ms per step, the caches, the last token)."""
    import torch
    B, P = prompt.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill({"tokens": prompt}, kv_len=P + steps)
    cur = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fed, kept = [], []
    for i in range(steps):
        fed.append(cur)
        dl, caches = model.decode_step(caches, cur, P + i)
        if i < keep:
            kept.append(dl[:, 0].clone())
        cur = dl[:, 0].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del logits
    return (torch.cat(fed, 1), torch.stack(kept, 1) if kept else None,
            (t1 - t0) * 1e3,
            (t2 - t1) * 1e3 / steps, caches, cur)


def phase_smollm(dev, seed: int):
    """Phase 27: smollm-135m at full depth and width, bf16, the port's
    seeded init: prefill 8 × 2,048 (blockwise), 32 greedy steps, twice."""
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.models.lm import LM
    t_phase = time.perf_counter()
    arch, B, P, steps = SMOLLM
    cfg = cb.get_config(arch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    model = LM(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated(dev) - base
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    runs = []
    for _ in range(2):
        fed, kept, pre_ms, dec_ms, caches, cur = greedy(model, prompt, steps,
                                                        CHECK_STEPS)
        runs.append((fed, pre_ms, dec_ms))
    peak = torch.cuda.max_memory_allocated(dev) - at_start
    del caches, cur
    same = bool(torch.equal(runs[0][0], runs[1][0]))
    log(f"[serve] smollm-135m full ({cfg.n_layers} layers, d = "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv} KV, vocab "
        f"{cfg.vocab}, bf16, {model.param_count()} params, "
        f"{weights / 1e6:.1f} MB): prefill {B} x {P} "
        f"{runs[0][1]:.2f} / {runs[1][1]:.2f} ms "
        f"({B * P / (runs[1][1] * 1e-3):.0f} tokens/s), decode "
        f"{runs[0][2]:.3f} / {runs[1][2]:.3f} ms per step over {steps} "
        f"steps; peak {peak / 1e9:.3f} GB above the weights; greedy "
        f"tokens of the two runs {'equal' if same else 'DIFFER'}")
    require(same, "two greedy runs gave different tokens")
    seq = torch.cat([prompt, runs[0][0][:, :CHECK_STEPS]], 1)
    check = full_width_check("smollm-135m", model, cfg, {"tokens": seq}, P,
                             kept)
    out = {"params": model.param_count(), "weights_mb": weights / 1e6,
           "prefill_ms": [r[1] for r in runs],
           "prefill_tokens_per_s": B * P / (runs[1][1] * 1e-3),
           "decode_ms_per_step": [r[2] for r in runs], "peak_gb": peak / 1e9,
           **check}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[serve] phase 27 (smollm) took {out['phase_s']:.1f} s")
    return model, out


def phase_full_width(dev, seed: int) -> dict:
    """Phase 27, continued: four more architectures at full width, their
    depth cut as FULL_WIDTH_CUTS says, bf16: prefill, 4 decode steps."""
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.models.lm import LM
    t_phase = time.perf_counter()
    out = {}
    for arch, (over, B, P, enc_len, why) in FULL_WIDTH_CUTS.items():
        t0 = time.perf_counter()
        cfg = nodrop(cb.get_config(arch).replace(**over))
        log(f"[serve] {arch}: cut: {why}")
        model = LM(cfg, device=dev, seed=seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch = model_batch(cfg, gen, B, P + CHECK_STEPS, enc_len)
        pre = dict(batch, tokens=batch["tokens"][:, :P])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, caches = model.prefill(pre, kv_len=P + CHECK_STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        kept = []
        for t in range(P, P + CHECK_STEPS):
            dl, caches = model.decode_step(caches, batch["tokens"][:, t:t + 1],
                                           t)
            kept.append(dl[:, 0].clone())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del caches
        log(f"[serve] {arch} full width (d = {cfg.d_model}, "
            f"{cfg.n_layers} layers, bf16, {model.param_count()} params): "
            f"prefill {B} x {P} {(t2 - t1) * 1e3:.1f} ms, decode "
            f"{(t3 - t2) * 1e3 / CHECK_STEPS:.2f} ms per step")
        check = full_width_check(arch, model, cfg, batch, P,
                                 torch.stack(kept, 1))
        del model, kept, batch, pre
        torch.cuda.empty_cache()
        out[arch] = {"prefill_ms": (t2 - t1) * 1e3,
                     "decode_ms_per_step": (t3 - t2) * 1e3 / CHECK_STEPS,
                     "s": time.perf_counter() - t0, **check}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[serve] phase 27 (cut architectures) took {out['phase_s']:.1f} s")
    return out


def phase_weight_compress(model, seed: int, errs: dict):
    """Phase 28: examples/weight_compress.py on the port: |wi_up| of every
    layer of phase 27's smollm-135m, stacked, factored by bpp through
    ``aunmf.fit`` on ``backend="cuda"`` at k = 4, 8, 16, 32, each fit held
    against ``backend="dense"`` from the same W0/H0; gram, ts_matmul and
    ts_matmul_t against their plain versions at k = 4 and 32, and timed at
    k = 32."""
    import math

    import torch
    from repro_torch.core import aunmf
    from repro_torch.kernels import ops, ref
    t_phase = time.perf_counter()
    wi = torch.stack([blk.ffn.mlp.wi_up.detach()
                      for blk in model.dec.layers()])
    L, D, F = wi.shape
    A = wi.reshape(L * D, F).float().abs().contiguous()
    del wi
    m, n = A.shape
    log(f"[compress] |W_ffn| of smollm-135m: {m} x {n} fp32 "
        f"({A.numel() * 4 / 1e6:.1f} MB)")
    gen = torch.Generator(device=A.device).manual_seed(seed)
    launches: dict = {}
    fits = {}
    for k in WC_KS:
        H0 = torch.rand((k, n), generator=gen, device=A.device)
        W0 = torch.zeros((m, k), device=A.device)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aunmf.fit(A, k, algo="bpp", iters=WC_ITERS, H0=H0, W0=W0,
                        backend="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: c for name, c in ops.LAUNCHES.items() if c}
        add_launches(launches, counts)
        dense = aunmf.fit(A, k, algo="bpp", iters=WC_ITERS, H0=H0, W0=W0,
                          backend="dense")
        rel = float(res.rel_errors[-1])
        rel_d = float(dense.rel_errors[-1])
        gap = abs(rel - rel_d) / rel_d
        ratio = A.numel() / (k * (m + n))
        ok = gap <= WC_REL_TOL and math.isfinite(rel)
        want = {"gram": 3 * WC_ITERS, "ts_matmul": WC_ITERS,
                "ts_matmul_t": WC_ITERS}
        log(f"[compress] k = {k:2d}: rel_err {rel:.6f} (dense {rel_d:.6f}, "
            f"{gap:.2e} relative, tol {WC_REL_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}; compression {ratio:.1f}x; "
            f"{wall * 1e3 / WC_ITERS:.2f} ms/iter (set-up included); "
            f"launches {counts} (expected {want})")
        require(ok, f"weight compression k = {k}: cuda and dense disagree")
        require(counts == want, f"k = {k}: launches {counts}, not {want}")
        fits[k] = {"rel_err": rel, "rel_err_dense": rel_d, "ratio": ratio,
                   "ms_per_iter": wall * 1e3 / WC_ITERS, "launches": counts}
        del res, dense
    timings = {}
    for k in WC_CHECK_KS:
        Ht = torch.rand((n, k), generator=gen, device=A.device)
        W = torch.rand((m, k), generator=gen, device=A.device)
        for name, got, want in (
                ("ts_matmul", ops.ts_matmul(A, Ht), ref.ts_matmul(A, Ht)),
                ("ts_matmul_t", ops.ts_matmul_t(A, W), ref.ts_matmul_t(A, W)),
                ("gram", ops.gram(W), ref.gram(W)),
                ("gram", ops.gram(Ht), ref.gram(Ht))):
            torch.cuda.synchronize()
            abs_err, err = scaled_err(got, want)
            ok = err <= TOL["float32"]
            log(f"[compress] {name:12s} k = {k:2d} scaled err {err:.3e} "
                f"(tol {TOL['float32']:.0e}) abs {abs_err:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            require(ok, f"{name} at k = {k} on |W_ffn| disagrees with its "
                        f"plain version: {err:.3e}")
            e = errs.setdefault(name, [0.0, 0.0])
            e[0], e[1] = max(e[0], abs_err), max(e[1], err)
        if k != max(WC_CHECK_KS):
            continue
        f4 = 4
        plans = {
            "ts_matmul": (lambda: ops.ts_matmul(A, Ht),
                          lambda: ref.ts_matmul(A, Ht),
                          lambda: torch.matmul(A, Ht),
                          (m * n + n * k) * f4, m * k * f4, 2.0 * m * n * k),
            "ts_matmul_t": (lambda: ops.ts_matmul_t(A, W),
                            lambda: ref.ts_matmul_t(A, W),
                            lambda: torch.matmul(A.T, W),
                            (m * n + m * k) * f4, n * k * f4,
                            2.0 * m * n * k),
            "gram": (lambda: ops.gram(W), lambda: ref.gram(W),
                     lambda: torch.matmul(W.T, W), m * k * f4, k * k * f4,
                     1.0 * m * k * (k + 1)),
        }
        for name, (kern, plain, lib, rb, wb, flops) in plans.items():
            p1, k1, k2, p2 = (time_ms(f, 50) for f in (plain, kern, kern,
                                                       plain))
            lib_ms = time_ms(lib, 50)
            b_ms, b_by = bound_ms(rb, wb, 3 * flops, "tf32")
            timings[name] = {"ms_wc": min(k1, k2), "plain_ms_wc": min(p1, p2),
                             "library_ms_wc": lib_ms, "bound_ms_wc": b_ms,
                             "bound_by_wc": b_by, "wc_shape": [m, n, k]}
            log(f"[compress] {name:12s} k = {k} on {m} x {n}: kernel "
                f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
                f"torch.matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    for name in timings:
        timings[name]["launches_wc"] = launches.get(name, 0)
    del A
    torch.cuda.empty_cache()
    summary = {"shape": [m, n], "fits": fits,
               "phase_s": time.perf_counter() - t_phase}
    log(f"[compress] phase 28 took {summary['phase_s']:.1f} s")
    return launches, summary, timings


# ----------------------------------------------------------------------------
# Phases 29–32: training (optim/, train/, distributed/sharding.py, moe_ep)

#: phase 29: a gradient leaf on the card against the CPU port's, scaled;
#: a leaf zero up to rounding (≤ TRAIN_ZERO_SHARE of the largest entry of
#: the whole gradient: a key bias under softmax's shift invariance) must
#: stay there on both
TRAIN_GRAD_TOL = 1e-4
TRAIN_ZERO_SHARE = 1e-6
#: phase 30: arch, batch, sequence, steps on one batch, the loop's steps,
#: its checkpoint interval and the step its failure is injected at
TRAIN_FULL = ("smollm_135m", 8, 2_048, 8)
TRAIN_LOOP = (6, 2, 3)
#: phase 30: the bf16 step's mean loss against its fp32 twin's, relative.
#: A mean over B·S tokens, so rounding averages out (read on an H100:
#: 1.7e-6); a loss taken over part of the tokens would be off by percents
TRAIN_LOSS_TOL = 1e-3
#: phase 30: two microbatches' gradients against one batch's, relative
#: L2.  The same fp32-accumulated sums, rounded to bf16 apart (bf16's
#: unit roundoff 2^-8 = 3.9e-3; read on an H100: 2.19e-3)
TRAIN_MB_TOL = 1e-2
#: phase 31: arch, layers kept, batch, sequence, steps
TRAIN_MOE = ("dbrx_132b", 1, 1, 512, 3)
#: phase 32: moe_ep at mp = 1 against moe_local, scaled; the sharded
#: Adafactor step of reduced dbrx against the plain one, each leaf of the
#: state scaled
EP_TOL = 1e-6


def _tree_diff(a, b) -> float:
    """The largest |a − b| over two trees of tensors, matched by key."""
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    return max(tree_leaves(tree_map(
        lambda x, y: float((x.float() - y.float()).abs().max()), a, b)))


def _grad_errs(got, want) -> tuple[float, str]:
    """The worst scaled error of ``got`` against ``want`` over the leaves
    (TRAIN_ZERO_SHARE's rule for leaves zero up to rounding) and its key
    path."""
    from repro_torch.optim.optimizers import tree_leaves
    top = max(float(t.abs().max()) for t in tree_leaves(want))
    worst, where = 0.0, ""

    def walk(g, w, path):
        nonlocal worst, where
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
            return
        if isinstance(w, list):
            for i, (x, y) in enumerate(zip(g, w)):
                walk(x, y, f"{path}/{i}")
            return
        if w is None:
            return
        g, w = g.double().cpu(), w.double().cpu()
        wmax = float(w.abs().max())
        if wmax <= TRAIN_ZERO_SHARE * top:
            err = 0.0 if float(g.abs().max()) <= TRAIN_ZERO_SHARE * top \
                else float("inf")
        else:
            err = float((g - w).abs().max()) / wmax
        if err > worst:
            worst, where = err, path
    walk(got, want, "")
    return worst, where


def phase_train_reduced(dev, seed: int) -> dict:
    """Phase 29: every architecture's reduced config, fp32, on the card."""
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import make_lm_loader
    from repro_torch.optim.optimizers import OptConfig, tree_map
    from repro_torch.train import steps
    t_phase = time.perf_counter()
    out = {}
    shape = cb.ShapeConfig("train", 32, 2, "train")
    for arch in cb.ARCH_IDS:
        cfg = cb.get_reduced_config(arch)
        opt = OptConfig(kind="adamw", lr=3e-3, warmup_steps=1,
                        total_steps=20, weight_decay=0.0)
        host = steps.init_train_state(cfg, opt, seed, device="cpu")
        state = tree_map(lambda t: t.to(dev), host)
        hbatch = make_lm_loader(cfg, shape, seed=seed, device="cpu")(0)
        batch = {k: v.to(dev) for k, v in hbatch.items()}
        _, _, g_cpu = steps.grads_of(cfg, host["params"], [hbatch])
        _, _, g_dev = steps.grads_of(cfg, state["params"], [batch])
        err, where = _grad_errs(g_dev, g_cpu)
        step = steps.make_train_step(cfg, opt)
        losses = []
        for _ in range(5):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        finite = all(map(math.isfinite, losses)) and math.isfinite(
            float(m["grad_norm"]))
        ok = err <= TRAIN_GRAD_TOL and finite and losses[-1] < losses[0]
        log(f"[train] {arch:20s} reduced fp32: gradients on the card vs the "
            f"CPU port {err:.2e} (worst leaf {where or '-'}; tol "
            f"{TRAIN_GRAD_TOL:.0e}); 5 adamw steps "
            f"{' '.join(f'{x:.4f}' for x in losses)} "
            f"{'ok' if ok else 'FAIL'}")
        require(err <= TRAIN_GRAD_TOL, f"{arch}: gradients on the card "
                f"disagree with the CPU port ({where})")
        require(finite and losses[-1] < losses[0],
                f"{arch}: five steps on one batch did not descend")
        out[arch] = {"grad_err": err, "losses": losses}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] phase 29 took {out['phase_s']:.1f} s")
    return out


def _timed_steps(step, state, batch, n: int):
    import torch
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])               # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return state, losses, ms


def phase_train_smollm(dev, seed: int, ckdir: str) -> dict:
    """Phase 30: smollm-135m at full size, bf16, remat, AdamW."""
    import gc
    import shutil
    import statistics
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import make_lm_loader
    from repro_torch.optim.optimizers import OptConfig, tree_map
    from repro_torch.train import steps
    from repro_torch.train.loop import LoopConfig, train
    t_phase = time.perf_counter()
    arch, B, S, n_steps = TRAIN_FULL
    cfg = cb.get_config(arch)
    cell = cb.SHAPES["train_4k"]
    log(f"[train] {arch} full size: cut: train_4k's {cell.global_batch} x "
        f"{cell.seq_len} -> {B} x {S} (phase 27's shape); {cfg.n_layers} "
        f"layers, d = {cfg.d_model}, {cfg.param_dtype}, remat "
        f"{cfg.remat} ({cfg.remat_policy})")
    opt = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1,
                    total_steps=n_steps)
    shape = cb.ShapeConfig("train", S, B, "train")
    # earlier phases' cyclic garbage, freed mid-phase, would hide the peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    state0 = steps.init_train_state(cfg, opt, seed, device=dev)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated(dev) - base
    batch = make_lm_loader(cfg, shape, seed=seed, device=dev)(0)
    step = steps.make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    state, losses, ms = _timed_steps(step, state0, batch, n_steps)
    peak = torch.cuda.max_memory_allocated(dev) - at_start
    del state
    ms_step = statistics.median(ms[1:])
    out = {"state_gb": state_bytes / 1e9, "losses": losses, "step_ms": ms,
           "ms_per_step": ms_step,
           "tokens_per_s": B * S / (ms_step * 1e-3),
           "peak_gb_above_state": peak / 1e9}
    log(f"[train] {arch}: state {state_bytes / 1e9:.3f} GB (params "
        f"{cfg.param_dtype}, AdamW moments fp32); {n_steps} steps on one "
        f"batch, loss {' '.join(f'{x:.4f}' for x in losses)}; ms a step "
        f"{' '.join(f'{x:.1f}' for x in ms)} (median of steps 2–"
        f"{n_steps}: {ms_step:.1f} ms, {out['tokens_per_s']:.0f} tokens/s); "
        f"peak {peak / 1e9:.3f} GB above the state")
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
            f"{arch}: {n_steps} steps on one batch did not descend")

    # the bf16 forward's own distance from an fp32 twin; the loss and the
    # gradient against the twin's; two microbatches against one
    from repro_torch.optim.optimizers import tree_leaves
    params = state0["params"]
    params32 = tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        m16 = steps.model_of(cfg, params)
        twin = steps.model_of(fp32_cfg(cfg), params32)
        few = {k: v[:2] for k, v in batch.items()}
        e16 = scaled_err(m16(few)[0], twin(few)[0])[1]
        del m16, twin
    torch.cuda.empty_cache()

    def rel_l2(got, want):
        num = sum(float(((a.float() - b.float()) ** 2).sum())
                  for a, b in zip(tree_leaves(got), tree_leaves(want)))
        return math.sqrt(num / sum(float((b.float() ** 2).sum())
                                   for b in tree_leaves(want)))

    loss32, _, g32 = steps.grads_of(fp32_cfg(cfg), params32, [batch])
    loss32 = float(loss32)
    del params32
    _, _, g1 = steps.grads_of(cfg, params, [batch])
    e_g16 = rel_l2(g1, g32)
    del g32
    torch.cuda.empty_cache()
    e_loss = abs(losses[0] - loss32) / abs(loss32)
    _, _, g2 = steps.grads_of(cfg, params, [{k: v[:B // 2] for k, v in
                                             batch.items()},
                                            {k: v[B // 2:] for k, v in
                                             batch.items()}])
    e_mb = rel_l2(g2, g1)
    tol_g16 = BF16_FACTOR * e16
    _, _, g1b = steps.grads_of(cfg, params, [batch])
    repeat_equal = _tree_diff(g1, g1b) == 0.0
    del g1, g2, g1b
    torch.cuda.empty_cache()
    log(f"[train] {arch}: bf16 forward vs its fp32 twin {e16:.3e}; the bf16 "
        f"step's loss {losses[0]:.6f} vs the twin's {loss32:.6f}: "
        f"{e_loss:.3e} (tol {TRAIN_LOSS_TOL:.0e}) "
        f"{'ok' if e_loss <= TRAIN_LOSS_TOL else 'FAIL'}; the bf16 "
        f"gradient vs the twin's {e_g16:.3e} (tol {BF16_FACTOR:g} x "
        f"{e16:.3e} = {tol_g16:.3e}) "
        f"{'ok' if e_g16 <= tol_g16 else 'FAIL'}; two microbatches vs one, "
        f"gradients {e_mb:.3e} (tol {TRAIN_MB_TOL:.0e}) "
        f"{'ok' if e_mb <= TRAIN_MB_TOL else 'FAIL'}; one step's "
        f"gradients computed twice "
        f"{'bit-equal' if repeat_equal else 'DIFFER'}")
    require(e_loss <= TRAIN_LOSS_TOL, f"{arch}: the bf16 loss is off its "
            "fp32 twin's")
    require(e_g16 <= tol_g16, f"{arch}: the bf16 gradient is beyond the "
            "bf16 tolerance from its fp32 twin's")
    require(e_mb <= TRAIN_MB_TOL, f"{arch}: two microbatches disagree with "
            "one")
    out.update(bf16_fwd_vs_fp32=e16, loss_vs_fp32=e_loss,
               bf16_grad_vs_fp32=e_g16, microbatch_grad_err=e_mb,
               repeat_bit_equal=repeat_equal)

    # the loop: a failure injected, then bit-identical to the loop without
    total, every, fail_at = TRAIN_LOOP
    loader = make_lm_loader(cfg, shape, seed=seed, device=dev)
    finals, hists = [], []
    t0 = time.perf_counter()
    for i, inject in enumerate((None, fail_at)):
        d = os.path.join(ckdir, f"loop{i}")
        shutil.rmtree(d, ignore_errors=True)
        st = steps.init_train_state(cfg, opt, seed, device=dev)
        # the loop absorbs the injected failure and raises on any other
        st, hist = train(st, step, loader,
                         LoopConfig(total_steps=total, ckpt_every=every,
                                    ckpt_dir=d, log_every=100,
                                    max_failures=0 if inject is None else 1),
                         inject_failure_at=inject)
        finals.append(st)
        hists.append(hist)
    loop_s = time.perf_counter() - t0
    diff = _tree_diff(finals[0], finals[1])
    plain = [h["step"] for h in hists[0]]
    redo = [h["step"] for h in hists[1]]
    resumed_at = fail_at // every * every
    want_redo = list(range(1, fail_at + 1)) + list(range(resumed_at + 1,
                                                         total + 1))
    steps_ok = plain == list(range(1, total + 1)) and redo == want_redo
    log(f"[train] {arch}: train() {total} steps, checkpoints every {every}, "
        f"failure at step {fail_at}: steps run {plain} and {redo} (want "
        f"{want_redo}) {'ok' if steps_ok else 'WRONG'}; final state vs the "
        f"loop without the failure: max |diff| {diff:.3e} "
        f"{'bit-identical' if diff == 0.0 else 'DIFFER'}; both loops "
        f"{loop_s:.1f} s")
    require(steps_ok, f"{arch}: the loops ran other steps than one injected "
            "failure explains")
    require(diff == 0.0, f"{arch}: the resumed loop is not bit-identical")
    out.update(loop_bit_identical=True, loop_s=loop_s,
               loop_steps=redo)
    del finals, state0, params
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] phase 30 took {out['phase_s']:.1f} s")
    return out


def phase_train_moe(dev, seed: int) -> dict:
    """Phase 31: dbrx-132b at full width, depth cut, Adafactor."""
    import gc
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import make_lm_loader
    from repro_torch.optim.optimizers import OptConfig, tree_leaves
    from repro_torch.train import steps
    t_phase = time.perf_counter()
    arch, layers, B, S, n_steps = TRAIN_MOE
    full = cb.get_config(arch)
    cfg = full.replace(n_layers=layers)
    log(f"[train] {arch}: cut: depth {layers} of {full.n_layers} layers at "
        f"full width (d = {cfg.d_model}, {cfg.moe.n_experts} experts of "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}); batch {B} x {S}; "
        f"{cfg.param_dtype}, Adafactor")
    opt = OptConfig(kind="adafactor", lr=1e-3, warmup_steps=1,
                    total_steps=n_steps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    state = steps.init_train_state(cfg, opt, seed, device=dev)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated(dev) - base
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    # the factored second moments: rows and columns of every 2-D+ leaf
    moe_p = state["params"]["dec"]["groups"]["p0"]["ffn"]["moe"]
    moe_v = state["opt"]["v"]["dec"]["groups"]["p0"]["ffn"]["moe"]
    shapes_ok = True
    for name in ("wi_gate", "wi_up", "wo"):
        p, v = moe_p[name].shape, moe_v[name]
        shapes_ok &= (set(v) == {"vr", "vc"}
                      and tuple(v["vr"].shape) == tuple(p[:-1])
                      and tuple(v["vc"].shape) == tuple(p[:-2] + p[-1:]))
    scale_v = state["opt"]["v"]["dec"]["groups"]["p0"]["norm1"]["scale"]
    shapes_ok &= set(scale_v) == {"v"}       # one group: (1, D) not factored
    opt_bytes = sum(t.numel() * 4 for t in tree_leaves(state["opt"]["v"]))
    batch = make_lm_loader(cfg, cb.ShapeConfig("train", S, B, "train"),
                           seed=seed, device=dev)(0)
    step = steps.make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    state, losses, ms = _timed_steps(step, state, batch, n_steps)
    peak = torch.cuda.max_memory_allocated(dev) - at_start
    finite = all(map(math.isfinite, losses)) and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(state["params"]))
    log(f"[train] {arch} 1 layer: {n_params} params, state "
        f"{state_bytes / 1e9:.2f} GB (Adafactor's {opt_bytes / 1e6:.1f} MB); "
        f"expert state shapes {moe_v['wi_gate']['vr'].shape} / "
        f"{moe_v['wi_gate']['vc'].shape} for {moe_p['wi_gate'].shape} "
        f"{'ok' if shapes_ok else 'WRONG'}; {n_steps} steps, loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}, ms "
        f"{' '.join(f'{x:.0f}' for x in ms)}; peak {peak / 1e9:.2f} GB "
        f"above the state; {'finite' if finite else 'NOT FINITE'}")
    require(shapes_ok, f"{arch}: the factored state has the wrong shapes")
    require(finite, f"{arch}: a step is not finite")
    del state, batch
    torch.cuda.empty_cache()
    out = {"params": n_params, "state_gb": state_bytes / 1e9,
           "losses": losses, "step_ms": ms, "peak_gb_above_state": peak / 1e9,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[train] phase 31 took {out['phase_s']:.1f} s")
    return out


def phase_train_mesh(dev, seed: int) -> dict:
    """Phase 32: the sharded step and moe_ep on a one-rank NCCL mesh."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import make_lm_loader
    from repro_torch.models import moe
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import steps
    t_phase = time.perf_counter()
    cfg = cb.get_reduced_config("smollm_135m")
    opt = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=10)
    state = steps.init_train_state(cfg, opt, seed, device=dev)
    batch = make_lm_loader(cfg, cb.ShapeConfig("train", 32, 8, "train"),
                           seed=seed, device=dev)(0)
    ref, mref = steps.make_train_step(cfg, opt)(state, batch)
    with nccl_group():
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        sharded = steps.shard_state(state, mesh)
        dstep = steps.make_train_step(cfg, opt, rt=steps.make_runtime(mesh))
        new, m = dstep(sharded, batch)
        whole = steps.full_state(new)
        diff = _tree_diff(whole, ref)
        dcfg = cb.get_reduced_config("dbrx_132b")
        dcfg = dcfg.replace(moe=dataclasses.replace(dcfg.moe,
                                                    capacity_factor=4.0))
        p = moe.init_moe(seed, dcfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((4, 16, dcfg.d_model), generator=gen, device=dev)
        errs = {}
        for name, xs, dropless in (("a2a", x, False),
                                   ("psum", x[:1, :1], True)):
            y_ep, _ = moe.moe_ep(p, xs, dcfg, mesh)
            y_loc, _ = moe.moe_local(p, xs, dcfg, dropless=dropless)
            errs[name] = scaled_err(y_ep, y_loc)[1]
        # Adafactor on the shards (expert layers gathered on use) against
        # the plain step, no token dropped
        acfg = dcfg.replace(moe=dataclasses.replace(
            dcfg.moe, capacity_factor=float(dcfg.moe.n_experts)))
        aopt = OptConfig(kind="adafactor", lr=1e-3, warmup_steps=1,
                         total_steps=10)
        ast = steps.init_train_state(acfg, aopt, seed, device=dev)
        abatch = make_lm_loader(acfg, cb.ShapeConfig("train", 32, 8, "train"),
                                seed=seed, device=dev)(0)
        aref, _ = steps.make_train_step(acfg, aopt)(ast, abatch)
        anew, _ = steps.make_train_step(acfg, aopt,
                                        rt=steps.make_runtime(mesh))(
            steps.shard_state(ast, mesh), abatch)
        ada_err, ada_where = _grad_errs(steps.full_state(anew), aref)
    ok = diff == 0.0 and float(m["loss"]) == float(mref["loss"])
    ok_ep = max(errs.values()) <= EP_TOL
    ok_ada = ada_err <= EP_TOL
    log(f"[train] one-rank NCCL mesh (data 1, model 1): the sharded step of "
        f"reduced smollm vs the step without a mesh: max |diff| {diff:.3e}, "
        f"loss {float(m['loss']):.6f} / {float(mref['loss']):.6f} "
        f"{'bit-equal' if ok else 'DIFFER'}; moe_ep vs moe_local "
        f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (tol "
        f"{EP_TOL:.0e}) {'ok' if ok_ep else 'FAIL'}; reduced dbrx's "
        f"Adafactor step on the shards vs the plain step {ada_err:.2e} "
        f"(worst leaf {ada_where or '-'}; tol {EP_TOL:.0e}) "
        f"{'ok' if ok_ada else 'FAIL'}")
    require(ok, "the sharded step on one rank is not the plain step")
    require(ok_ep, "moe_ep at mp = 1 disagrees with moe_local")
    require(ok_ada, "Adafactor on the shards disagrees with the plain step")
    out = {"sharded_vs_plain": diff, "moe_ep_err": errs,
           "adafactor_sharded_err": ada_err,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[train] phase 32 took {out['phase_s']:.1f} s")
    return out


def phase_train(dev, seed: int) -> dict:
    """Phases 29–32 in order; checkpoints under build/train_ckpt/."""
    out = {"reduced": phase_train_reduced(dev, seed),
           "smollm": phase_train_smollm(
               dev, seed, os.path.join(ROOT, "build", "train_ckpt")),
           "moe": phase_train_moe(dev, seed),
           "mesh": phase_train_mesh(dev, seed)}
    out["phase_s"] = sum(v["phase_s"] for v in out.values())
    log(f"[train] phases 29–32 took {out['phase_s']:.1f} s")
    return out


#: phase 33: a count's roofline bound may exceed the measured time by this
#: share at most (more is an impossible reading: the count is wrong)
BOUND_OVER_MEASURED = 1.05
#: phase 33's live iterations a rule (after one to warm up)
COUNT_ITERS = 3
#: phase 35: stages × microbatches of (rows, width), fp32, TF32 off
PIPE = (4, 8, 4, 16)
PIPE_TOL = 1e-5
#: phase 34: per-rank wire bytes of an NMF cell against the cost model's
#: words × 4 B (plus the error byproduct's Gram and scalar), relative
DRYRUN_WIRE_TOL = 1e-6


def _wire_sig(entries) -> list:
    return [(c.op, str(c.dtype), tuple(c.shape), c.group_size)
            for c in entries]


def phase_count_nmf(A, seed: int, card: str) -> tuple[dict, dict]:
    """Phase 33 (NMF): each of mu and hals counted on fake tensors of
    Video's shape (``NMFSolver.lower_step``, backend "cuda") against one
    live iteration on the A phase 8 holds: the record's kernel calls equal
    the LAUNCHES of a live iteration, and its roofline bound on the H100
    (``roofline.hw``) stays within ``BOUND_OVER_MEASURED`` of the measured
    ms per iteration.  Then faun 1×1 on a one-rank NCCL group: the
    record's collectives equal ``record_wire``'s log of a live iteration
    (op, dtype, shape, group size, in order)."""
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.core.faun import make_faun_grid
    from repro_torch.kernels import ops
    from repro_torch.roofline.hw import H100
    from repro_torch.util.wire import record_wire
    t_phase = time.perf_counter()
    m, n = A.shape
    launches = {name: 0 for name in ops.LAUNCHES}
    out = {"shape": [m, n], "card": card}
    for algo in ("mu", "hals"):
        solver = NMFSolver(K, algo=algo, backend="cuda",
                           max_iters=COUNT_ITERS)
        t0 = time.perf_counter()
        rec = solver.lower_step(m, n)
        count_s = time.perf_counter() - t0
        rs = solver.prepare_state(A, seed=seed)
        solver.run_segment(rs, 1)
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solver.run_segment(rs, COUNT_ITERS)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / COUNT_ITERS
        delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        add_launches(launches, delta)
        live = {k: v / COUNT_ITERS for k, v in delta.items() if v}
        counted = dict(rec.kernel_calls())
        roof = rec.roofline(H100)
        bound = roof["step_lower_bound_s"] * 1e3
        share = bound / ms
        log(f"[count] {algo} serial {m} x {n}: counted in {count_s:.2f} s, "
            f"kernel calls {counted} (live a iteration {live}); "
            f"{rec.dot_flops:.4e} FLOPs, {rec.bytes / 1e9:.2f} GB; bound "
            f"{bound:.3f} ms ({roof['dominant']}) against {ms:.3f} ms "
            f"measured: {100 * share:.1f} % (card {card})")
        require(counted == live, f"{algo}: the record's kernel calls "
                                 f"{counted} are not a live iteration's "
                                 f"{live}")
        require(share <= BOUND_OVER_MEASURED,
                f"{algo}: the counted bound {bound:.3f} ms exceeds the "
                f"measured {ms:.3f} ms by more than "
                f"{100 * (BOUND_OVER_MEASURED - 1):.0f} %: the count is "
                f"wrong")
        out[algo] = {"kernel_calls": counted, "flops": rec.dot_flops,
                     "bytes": rec.bytes, "bound_ms": bound,
                     "bound_by": roof["dominant"], "ms_per_iter": ms,
                     "share": share, "count_s": count_s}
        del rs
        torch.cuda.empty_cache()
    with nccl_group():
        grid = make_faun_grid(1, 1)
        for algo in ("mu", "hals"):
            solver = NMFSolver(K, algo=algo, schedule="faun", grid=grid,
                               backend="cuda")
            rec = solver.lower_step(m, n)
            rs = solver.prepare_state(A, seed=seed)
            solver.run_segment(rs, 1)
            torch.cuda.synchronize()
            before = dict(ops.LAUNCHES)
            with record_wire() as wire:
                solver.run_segment(rs, 1)
            torch.cuda.synchronize()
            add_launches(launches, {k: ops.LAUNCHES[k] - before[k]
                                    for k in ops.LAUNCHES})
            got, want = _wire_sig(rec.collectives), _wire_sig(wire)
            log(f"[count] {algo} faun 1x1 (one-rank NCCL): the record's "
                f"{len(got)} collectives "
                f"{'equal' if got == want else 'DIFFER FROM'} the live "
                f"iteration's {len(want)}")
            require(got == want, f"faun {algo}: the record's collectives "
                                 f"{got} differ from the live {want}")
            out[f"faun_{algo}_collectives"] = len(got)
            del rs
            torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[count] phase 33 (NMF) took {out['phase_s']:.1f} s")
    return launches, out


def _timed_ms(fn, reps: int) -> float:
    """Least ms of ``reps`` calls (CUDA events), after one warm-up."""
    import torch
    fn()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def phase_count_models(dev, seed: int, card: str, prefill_ms=None,
                       train_ms=None) -> dict:
    """Phase 33 (models): phase 27's smollm-135m prefill (8 × 2,048, bf16)
    and phase 30's train step (8 × 2,048, bf16, remat, AdamW) counted on
    fake tensors, each split into FLOPs by rate, bytes and the largest
    ops, its bound printed beside the measured ms (phases 27 and 30's, or
    measured here when not given).  The eager ops' small operands sit in
    the 50 MB L2, so no share is required of these."""
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.models.lm import LM
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.roofline import counts
    from repro_torch.roofline.hw import H100
    from repro_torch.train import steps
    t_phase = time.perf_counter()
    arch, B, P, gen_steps = SMOLLM
    cfg = cb.get_config(arch)
    opt = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=8)
    tokens = torch.zeros((B, P), dtype=torch.int64, device=dev)
    if prefill_ms is None or train_ms is None:
        model = LM(cfg, device=dev, seed=seed)
        prefill_ms = prefill_ms or _timed_ms(
            lambda: model.prefill({"tokens": tokens}, kv_len=P + gen_steps),
            3)
        del model
        state = steps.init_train_state(cfg, opt, seed, device=dev)
        step = steps.make_train_step(cfg, opt)
        batch = {"tokens": tokens.int(), "labels": tokens.int()}
        train_ms = train_ms or _timed_ms(lambda: step(state, batch), 3)
        del state, step, batch
        torch.cuda.empty_cache()
    out = {"card": card}
    with counts.stand_in_card(), counts.fake_mode():
        model = LM(cfg, device=dev, seed=seed)
        fake_tokens = torch.zeros((B, P), dtype=torch.int64, device=dev)
        with counts.record_step() as pre:
            model.prefill({"tokens": fake_tokens}, kv_len=P + gen_steps)
        del model
        state = steps.init_train_state(cfg, opt, seed, device=dev)
        batch = {"tokens": fake_tokens.int(), "labels": fake_tokens.int()}
        with counts.record_step() as tr:
            steps.make_train_step(cfg, opt)(state, batch)
    for name, rec, ms in (("prefill", pre, prefill_ms),
                          ("train", tr, train_ms)):
        roof = rec.roofline(H100)
        bound = roof["step_lower_bound_s"] * 1e3
        top = sorted(rec.ops.items(), key=lambda kv: -kv[1])[:6]
        by_rate = {k: f"{v:.3e}" for k, v in rec.flops_by_rate.items()}
        log(f"[count] smollm-135m {name} {B} x {P}: {rec.dot_flops:.4e} "
            f"FLOPs {by_rate}, "
            f"{rec.bytes / 1e9:.2f} GB, {sum(rec.ops.values())} aten ops "
            f"(most: {top}); bound {bound:.2f} ms (compute "
            f"{roof['compute_s'] * 1e3:.2f}, memory "
            f"{roof['memory_s'] * 1e3:.2f}) against {ms:.2f} ms measured: "
            f"{100 * bound / ms:.1f} % (card {card})")
        out[name] = {"flops_by_rate": rec.flops_by_rate, "bytes": rec.bytes,
                     "aten_ops": sum(rec.ops.values()),
                     "compute_ms": roof["compute_s"] * 1e3,
                     "memory_ms": roof["memory_s"] * 1e3, "bound_ms": bound,
                     "measured_ms": ms, "share": bound / ms}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[count] phase 33 (models) took {out['phase_s']:.1f} s")
    return out


_DRYRUN_OK = "OK   "


def _dryrun_records(args: list) -> tuple[list, float]:
    """``python -m repro_torch.launch.dryrun <args> --no-save`` in a process
    of its own (the dry run owns its process's default group): the
    ``key=value`` fields of each record line, and the seconds it took."""
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *args, "--no-save"], env=env, capture_output=True,
                         text=True, timeout=900)
    secs = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        if line.startswith(("OK", "FAIL", "SKIP")):
            log(f"[dryrun] {line}")
    require(run.returncode == 0, f"dry run {args} exited "
                                 f"{run.returncode}: {run.stderr[-2000:]}")
    recs = []
    for line in run.stdout.splitlines():
        if line.startswith(("FAIL", "SKIP")):
            recs.append({"status": line.split()[0].lower(), "line": line})
        elif line.startswith(_DRYRUN_OK):
            fields = dict(tok.split("=", 1) for tok in line.split()
                          if "=" in tok)
            recs.append({"status": "ok", "line": line, **fields})
    return recs, secs


def phase_dryrun(card: str) -> dict:
    """Phase 34: the dry run on the card's host, each as a process of its
    own: the five NMF cells, then smollm-135m × train_4k on the single
    16×16 mesh.  Every record ok; each NMF cell's wire bytes per rank
    within ``DRYRUN_WIRE_TOL`` of the cost model's; seconds and the HBM
    fit against this card's memory printed (counted, not measured)."""
    import torch
    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"card": card, "card_memory": total}
    nmf, out["nmf_s"] = _dryrun_records(["--nmf"])
    require(len(nmf) == 5 and all(r["status"] == "ok" for r in nmf),
            f"the NMF dry run: {[r['line'] for r in nmf]}")
    cells = []
    for r in nmf:
        wire, model = float(r["wire_bytes"]), float(r["costmodel_bytes"])
        peak = float(r["peak_bytes"])
        rel = abs(wire - model) / model
        log(f"[dryrun] {' '.join(r['line'].split()[1:5])}: wire "
            f"{wire:.1f} B per rank, cost model {model:.1f} B (rel "
            f"{rel:.2e}); peak {peak / 1e9:.2f} GB counted, HBM fit "
            f"{'YES' if peak <= total else 'NO'} against {total / 1e9:.1f} "
            f"GB")
        require(rel <= DRYRUN_WIRE_TOL, f"NMF cell {r['line']}: wire bytes "
                                        f"{wire} vs cost model {model}")
        cells.append({"line": r["line"], "wire": wire, "model": model,
                      "peak": peak, "fits": peak <= total})
    out["nmf"] = cells
    lm, out["smollm_s"] = _dryrun_records(
        ["--arch", "smollm-135m", "--shape", "train_4k", "--mesh", "single"])
    require(len(lm) == 1 and lm[0]["status"] == "ok",
            f"smollm-135m × train_4k: {[r['line'] for r in lm]}")
    peak = float(lm[0]["peak_bytes"])
    log(f"[dryrun] smollm-135m × train_4k [single]: {out['smollm_s']:.1f} s; "
        f"peak {peak / 1e9:.2f} GB counted, HBM fit "
        f"{'YES' if peak <= total else 'NO'} against {total / 1e9:.1f} GB "
        f"(card {card})")
    out["smollm"] = {"line": lm[0]["line"], "peak": peak,
                     "fits": peak <= total}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dryrun] phase 34 took {out['phase_s']:.1f} s "
        f"(NMF {out['nmf_s']:.1f} s, smollm {out['smollm_s']:.1f} s)")
    return out


def _pipe_stage(p, x):
    import torch
    return torch.tanh(x @ p["w"])


def pipeline_rank(out: str) -> None:
    """Phase 35's rank: its stage of the GPipe pipeline on the card (gloo
    carries the activations and gradients between the four ranks), the
    gradient of mean(y²) for its slice, and the sequential stack run on
    the card on the same rank."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.pipeline import pipeline_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    S, NM, MB, D = PIPE
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(11)
    W = torch.randn((S, D, D), generator=gen) / D ** 0.5
    x = torch.randn((NM, MB, D), generator=gen).to(dev)
    mesh = init_device_mesh("cpu", (S,), mesh_dim_names=("pp",))
    r = dist.get_rank()
    w = W[r:r + 1].to(dev).requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        y = pipeline_apply(_pipe_stage, {"w": w}, x, mesh, "pp")
        (y ** 2).mean().backward()
        torch.cuda.synchronize()
        err = None
    except Exception as e:  # noqa: BLE001 — reported by the parent
        err = f"{type(e).__name__}: {e}"
    secs = time.perf_counter() - t0
    Wf = W.to(dev).requires_grad_(True)
    h = x
    for s in range(S):
        h = _pipe_stage({"w": Wf[s]}, h)
    (h ** 2).mean().backward()
    res = {"err": err, "s": secs}
    if err is None:
        res.update({"y": (y - h).abs().max().item(),
                    "g": (w.grad[0] - Wf.grad[r]).abs().max().item(),
                    "g_max": w.grad.abs().max().item()})
    torch.save(res, os.path.join(out, f"pipe_{r}.pt"))


def phase_pipeline(dev, card: str) -> dict:
    """Phase 35: ``distributed.pipeline.pipeline_apply`` on four gloo ranks
    sharing the card (spawned as phase 15g spawns), 4 stages × 8
    microbatches of (4, 16) in fp32 with TF32 off: output and gradient
    within ``PIPE_TOL`` of the sequential stack on the card.  The hops are
    gloo all-to-alls of CUDA tensors: if gloo refuses them the phase fails
    and says so (nothing is copied to the host)."""
    import tempfile
    import torch
    from repro_torch.distributed.pipeline import bubble_fraction
    from repro_torch.util import dist as rdist
    t_phase = time.perf_counter()
    S, NM, MB, D = PIPE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipe_") as tmp:
        rdist.spawn(pipeline_rank, S, tmp, backend="gloo",
                    device=f"cuda:{dev.index or 0}")
        ranks = [torch.load(os.path.join(tmp, f"pipe_{r}.pt"))
                 for r in range(S)]
    errs = [r["err"] for r in ranks if r["err"]]
    require(not errs, f"the pipeline on CUDA tensors over gloo failed "
                      f"(gloo's all-to-all on CUDA tensors): {errs[:1]}")
    y_err = max(r["y"] for r in ranks)
    g_err = max(r["g"] for r in ranks)
    ticks = NM + S - 1
    log(f"[pipeline] {S} stages x {NM} microbatches of ({MB}, {D}) fp32 on "
        f"four gloo ranks of the card: {ticks} ticks, bubble "
        f"{bubble_fraction(S, NM):.3f}; output {y_err:.2e}, gradient "
        f"{g_err:.2e} from the sequential stack (tol {PIPE_TOL:.0e}); "
        f"{max(r['s'] for r in ranks):.2f} s forward + backward (card "
        f"{card})")
    require(y_err <= PIPE_TOL and g_err <= PIPE_TOL,
            f"the pipeline disagrees with the sequential stack: output "
            f"{y_err:.2e}, gradient {g_err:.2e}")
    require(all(r["g_max"] > 0 for r in ranks), "a stage got no gradient")
    out = {"ticks": ticks, "bubble": bubble_fraction(S, NM), "y_err": y_err,
           "g_err": g_err, "phase_s": time.perf_counter() - t_phase}
    log(f"[pipeline] phase 35 took {out['phase_s']:.1f} s")
    return out


# ----------------------------------------------------------------------------
# Phase 36: tensor and sequence parallelism over "model"

#: phase 36: smollm-135m at full size, (batch, sequence, decode steps): the
#: train step and prefill plus decode on a (1, 3) mesh, where its 9 heads,
#: 3 KV heads, 1,536 FFN columns and 49,152-token vocabulary all divide;
#: the train step again on (1, 4) with seq_parallel
TP_SMOLLM = (8, 2_048, 8)
#: phase 36: qwen2-72b at full width, (layers kept, batch, prompt, decode
#: steps) on (1, 4)
TP_QWEN = (2, 2, 2_048, 8)
TP_RANKS = 4


def _kv_len(prompt: int, steps: int, *tps) -> int:
    """The smallest cache length that holds the prompt and the steps and
    divides over every "model" size in ``tps`` (the KV split needs it)."""
    n = math.lcm(*tps)
    return -(-(prompt + steps) // n) * n


def _rel_l2(got, want) -> float:
    from repro_torch.optim.optimizers import tree_leaves
    num = sum(float(((a.float() - b.float()) ** 2).sum())
              for a, b in zip(tree_leaves(got), tree_leaves(want)))
    return math.sqrt(num / sum(float((b.float() ** 2).sum())
                               for b in tree_leaves(want)))


def _leaf_paths(tree, path: str = "") -> list:
    """The "a/b/c" path of each leaf of ``tree``, in ``tree_leaves``'
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree)
                for q in _leaf_paths(tree[k], f"{path}/{k}".lstrip("/"))]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree)
                for q in _leaf_paths(v, f"{path}/{i}".lstrip("/"))]
    return [] if tree is None else [path]


def _leaf_rel_l2(got, want) -> list:
    """Each leaf's ‖got − want‖ / ‖want‖, in ``tree_leaves``' order."""
    from repro_torch.optim.optimizers import tree_leaves
    out = []
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        num = float((a.float() - b.float()).norm())
        den = float(b.float().norm())
        out.append(num / den if den > 0 else (0.0 if num == 0 else math.inf))
    return out


def _worst_leaf(dist, twin) -> tuple:
    """(index, ratio) of the leaf whose distance in ``dist`` stands
    farthest above its fp32 twin's in ``twin``."""
    ratios = [d / t if t > 0 else (0.0 if d == 0 else math.inf)
              for d, t in zip(dist, twin)]
    i = max(range(len(ratios)), key=ratios.__getitem__)
    return i, ratios[i]


def _tp_cfgs():
    from repro_torch.configs import base as cb
    layers = TP_QWEN[0]
    return (cb.get_config("smollm_135m"),
            cb.get_config("qwen2_72b").replace(n_layers=layers))


def _tp_params(cfg, seed: int, dev):
    """The port's seeded init of ``cfg`` in the train state's stacked
    layout, on ``dev``."""
    from repro_torch.models.lm import LM
    from repro_torch.util.convert import stack_params
    return stack_params(LM(cfg, device=dev, seed=seed).tree())


def _greedy_ref(cfg, params, prompt, kv_len: int, steps: int, fed=None,
                extra=None):
    """Prefill and ``steps`` greedy decode steps through the serving steps
    (``make_prefill_step``, ``make_decode_step``) on one card: (the fed
    tokens (B, steps), each step's logits (steps + 1, B, V), prefill ms,
    decode ms a step).  ``fed`` forces the tokens (an fp32
    twin's run on the bf16 run's tokens); ``extra`` adds leaves to the
    prefill's batch (an encoder's frames)."""
    import torch
    from repro_torch.train import steps as st
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches = st.make_prefill_step(cfg, kv_len)(
        params, {"tokens": prompt, **(extra or {})})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decode = st.make_decode_step(cfg)
    cur = last.argmax(-1).to(torch.int32)[:, None] if fed is None \
        else fed[:, :1]
    toks, outs = [], [last.float()]
    for i in range(steps):
        toks.append(cur)
        lg, caches = decode(params, caches, cur, prompt.shape[1] + i)
        outs.append(lg.float())
        cur = (lg.argmax(-1).to(torch.int32)[:, None] if fed is None
               else fed[:, i + 1:i + 2])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del caches
    return (torch.cat(toks, 1), torch.stack(outs), (t1 - t0) * 1e3,
            (t2 - t1) * 1e3 / steps)


def tp_rank(out: str, seed: int, device: str) -> None:
    """Phase 36's rank (four share the card over gloo): the sharded runs,
    each held by rank 0 against the unsharded references in ``out``."""
    import gc
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import make_lm_loader
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.roofline.counts import tensor_bytes
    from repro_torch.train import steps as st
    r = dist.get_rank()
    dev = torch.device(device)
    ref = torch.load(os.path.join(out, "ref.pt"), map_location=dev)
    res = {"err": None}
    smollm, qwen = _tp_cfgs()
    B, S, n_dec = TP_SMOLLM
    opt = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=10)
    batch = make_lm_loader(smollm, cb.ShapeConfig("train", S, B, "train"),
                           seed=seed, device=dev)(0)

    def timed(fn, group, n=2):
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            dist.barrier(group=group)
            t0 = time.perf_counter()
            val = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return val, ms

    def grads_check(tag, mesh, rt, state, n):
        # the train step's gradient, as its ``sharded_grads`` returns it
        kept, sharded_grads = [], st.sharded_grads

        def keep(*a, **k):
            out = sharded_grads(*a, **k)
            kept[:] = [out[2]]
            return out
        st.sharded_grads = keep
        try:
            (_, m), ms = timed(lambda: st.make_train_step(
                smollm, opt, rt=rt)(state, batch), mesh.get_group("model"),
                n)
        finally:
            st.sharded_grads = sharded_grads
        whole = st.full_state(st.wrap_shards(kept.pop(), state["params"],
                                             mesh))
        if r == 0:
            res[tag] = {"step_ms": ms, "loss": float(m["loss"]),
                        "grad_vs_ref": _rel_l2(whole, ref["smollm_g16"]),
                        "grad_leaf_vs_ref": _leaf_rel_l2(whole,
                                                         ref["smollm_g16"])}
        del whole
        torch.cuda.empty_cache()

    try:
        whole = _tp_params(smollm, seed, dev)
        state = {"params": whole, "step": torch.zeros(
            (), dtype=torch.int32, device=dev)}
        from repro_torch.optim.optimizers import init_opt_state
        state["opt"] = init_opt_state("adamw", whole)
        mesh3 = DeviceMesh(dev.type, [list(range(3))],
                           mesh_dim_names=("data", "model"))
        mesh4 = DeviceMesh(dev.type, [list(range(TP_RANKS))],
                           mesh_dim_names=("data", "model"))
        if mesh3.get_coordinate() is not None:
            rt3 = st.make_runtime(mesh3)
            grads_check("smollm_13", mesh3, rt3, st.shard_state(state, mesh3),
                        1)
            params = st.shard_params(whole, mesh3)
            prompt = ref["smollm_prompt"]
            kv = _kv_len(S, n_dec, 3, TP_RANKS)
            dist.barrier(group=mesh3.get_group("model"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, caches = st.make_prefill_step(smollm, kv, rt=rt3)(
                params, {"tokens": prompt})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            decode = st.make_decode_step(smollm, rt=rt3)
            fed, outs = ref["smollm_fed"], [last.float()]
            for i in range(n_dec):
                lg, caches = decode(params, caches, fed[:, i:i + 1], S + i)
                outs.append(lg.float())
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            cache_len = {c["k"].shape[1] for layer in caches
                         for c in layer.values()}
            del caches
            if r == 0:
                got = torch.stack(outs)
                # the greedy tokens: the sharded run's choice at each of
                # the n_dec fed positions against the unsharded run's; a
                # flip is a near-tie when the unsharded logits' margin
                # between the two tokens is within 2 × BF16_FACTOR × the
                # fp32 twin's distance on that row (the logits rule, row
                # by row)
                want = fed.T.long()                           # (n_dec, B)
                ref_l = ref["smollm_logits"][:n_dec]
                pick = got[:n_dec].argmax(-1)
                flip = pick != want
                margin = (ref_l.gather(-1, want[..., None])
                          - ref_l.gather(-1, pick[..., None]))[..., 0]
                tie = (margin / ref["smollm_twin_row"][:n_dec])[flip]
                res["smollm_13_serve"] = {
                    "prefill_ms": (t1 - t0) * 1e3,
                    "decode_ms": (t2 - t1) * 1e3 / n_dec,
                    "err": scaled_err(got, ref["smollm_logits"])[1],
                    "agree": int((~flip).sum()), "of": flip.numel(),
                    "worst_tie": float(tie.max()) if tie.numel() else 0.0,
                    "cache_len": sorted(cache_len), "kv_len": kv}
            del params
        dist.barrier(group=mesh4.get_group("model"))
        torch.cuda.empty_cache()
        grads_check("smollm_14_sp", mesh4,
                    st.make_runtime(mesh4, seq_parallel=True),
                    st.shard_state(state, mesh4), 1)
        del state, whole
        gc.collect()
        torch.cuda.empty_cache()
        res["smollm_left_bytes"] = torch.cuda.memory_allocated(dev)

        # qwen2-72b at full width, depth cut, on (1, 4): two ranks at a
        # time make the whole seeded weights (8.5 GB, and twice the
        # embedding table in fp32 on the way) and keep their shards
        _, Bq, Pq, nq = TP_QWEN
        group4 = mesh4.get_group("model")
        for i in range(0, TP_RANKS, 2):
            if i <= r < i + 2:
                whole = _tp_params(qwen, seed, dev)
                params = st.shard_params(whole, mesh4)
                del whole
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier(group=group4)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        rt4 = st.make_runtime(mesh4)
        kv = _kv_len(Pq, nq, TP_RANKS)
        prompt, fed = ref["qwen_prompt"], ref["qwen_fed"]
        dist.barrier(group=group4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, caches = st.make_prefill_step(qwen, kv, rt=rt4)(
            params, {"tokens": prompt})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode = st.make_decode_step(qwen, rt=rt4)
        outs = [last.float()]
        for i in range(nq):
            lg, caches = decode(params, caches, fed[:, i:i + 1], Pq + i)
            outs.append(lg.float())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res["qwen"] = {
            "prefill_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3 / nq,
            "param_bytes": tensor_bytes(params),
            "cache_bytes": tensor_bytes(caches),
            "cache_len": sorted({c["k"].shape[1] for layer in caches
                                 for c in layer.values()}),
            "kv_len": kv, "base_bytes": base,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        if r == 0:
            res["qwen"]["err"] = scaled_err(torch.stack(outs),
                                            ref["qwen_logits"])[1]
        del caches, params
    except Exception as e:  # noqa: BLE001 — reported by the parent
        import traceback
        res["err"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    torch.save(res, os.path.join(out, f"tp_{r}.pt"))


def phase_tp(dev, seed: int, card: str) -> dict:
    """Phase 36: the model tensor-parallel over "model" (and sequence
    parallel) on four gloo ranks sharing the card, as phase 35 spawns
    them, against the unsharded run on the card: smollm-135m at full size
    (bf16, remat) on (1, 3), its train step's gradient and its prefill
    plus ``TP_SMOLLM`` decode steps (the KV length split over "model"),
    its train step on (1, 4) with seq_parallel; qwen2-72b at full width,
    depth cut to ``TP_QWEN``'s layers, prefill and decode on (1, 4).  Each
    within ``BF16_FACTOR`` × the unsharded bf16 run's own distance from
    its fp32 twin (phases 27 and 30's rule; the gradient leaf by leaf,
    each against the same leaf's twin distance; a greedy token that flips
    only at a near-tie of that rule, row by row), each loss within
    ``TRAIN_LOSS_TOL``; the ms of each step beside the card."""
    import gc
    import tempfile
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import make_lm_loader
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train import steps as st
    from repro_torch.util import dist as rdist
    t_phase = time.perf_counter()
    smollm, qwen = _tp_cfgs()
    B, S, n_dec = TP_SMOLLM
    _, Bq, Pq, nq = TP_QWEN
    gc.collect()
    torch.cuda.empty_cache()
    ref, out = {}, {"card": card}
    # the unsharded references on the card, and the fp32 twins' distance
    params = _tp_params(smollm, seed, dev)
    batch = make_lm_loader(smollm, cb.ShapeConfig("train", S, B, "train"),
                           seed=seed, device=dev)(0)
    loss16, _, g16 = st.grads_of(smollm, params, [batch])
    from repro_torch.optim.optimizers import OptConfig, init_opt_state
    opt = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=10)
    state = {"params": params, "opt": init_opt_state("adamw", params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.make_train_step(smollm, opt)(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    del state
    p32 = tree_map(lambda t: t.float(), params)
    loss32, _, g32 = st.grads_of(fp32_cfg(smollm), p32, [batch])
    e_g = _rel_l2(g16, g32)
    e_g_leaf, leaf_names = _leaf_rel_l2(g16, g32), _leaf_paths(g16)
    del g32
    ref["smollm_g16"] = g16
    gen = torch.Generator(device=dev).manual_seed(seed + 36)
    prompt = torch.randint(0, smollm.vocab, (B, S), generator=gen,
                           device=dev)
    kv = _kv_len(S, n_dec, 3, TP_RANKS)
    fed, lg16, pre_ms, dec_ms = _greedy_ref(smollm, params, prompt, kv,
                                            n_dec)
    _, lg32, _, _ = _greedy_ref(fp32_cfg(smollm), p32, prompt, kv, n_dec,
                                fed=fed)
    e_s = scaled_err(lg16, lg32)[1]
    ref.update(smollm_prompt=prompt, smollm_fed=fed, smollm_logits=lg16,
               smollm_twin_row=(lg16 - lg32).abs().amax(-1))
    out["smollm_ref"] = {"loss": float(loss16), "loss32": float(loss32),
                         "step_ms": step_ms,
                         "grad_vs_fp32": e_g, "serve_vs_fp32": e_s,
                         "grad_leaf_vs_fp32": e_g_leaf,
                         "prefill_ms": pre_ms, "decode_ms": dec_ms}
    del params, p32, lg32
    torch.cuda.empty_cache()
    qparams = _tp_params(qwen, seed, dev)
    qprompt = torch.randint(0, qwen.vocab, (Bq, Pq), generator=gen,
                            device=dev)
    qkv = _kv_len(Pq, nq, TP_RANKS)
    qfed, q16, qpre, qdec = _greedy_ref(qwen, qparams, qprompt, qkv, nq)
    q32p = tree_map(lambda t: t.float(), qparams)
    del qparams
    torch.cuda.empty_cache()
    _, q32, _, _ = _greedy_ref(fp32_cfg(qwen), q32p, qprompt, qkv, nq,
                               fed=qfed)
    e_q = scaled_err(q16, q32)[1]
    del q32p, q32
    ref.update(qwen_prompt=qprompt, qwen_fed=qfed, qwen_logits=q16)
    out["qwen_ref"] = {"serve_vs_fp32": e_q, "prefill_ms": qpre,
                       "decode_ms": qdec}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        torch.save(ref, os.path.join(tmp, "ref.pt"))
        del ref, g16, lg16, q16, batch
        gc.collect()
        torch.cuda.empty_cache()
        t_spawn = time.perf_counter()
        where = f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"
        rdist.spawn(tp_rank, TP_RANKS, tmp, seed, where, backend="gloo",
                    device=where)
        out["ranks_s"] = time.perf_counter() - t_spawn
        ranks = [torch.load(os.path.join(tmp, f"tp_{r}.pt"))
                 for r in range(TP_RANKS)]
    errs = [x["err"] for x in ranks if x["err"]]
    require(not errs, f"phase 36 failed on a rank: {errs[0][-3000:]}"
            if errs else "")
    r0 = ranks[0]
    sref, qref = out["smollm_ref"], out["qwen_ref"]
    tol_g, tol_s, tol_q = (BF16_FACTOR * sref["grad_vs_fp32"],
                           BF16_FACTOR * sref["serve_vs_fp32"],
                           BF16_FACTOR * qref["serve_vs_fp32"])
    for tag, mesh, tp in (("smollm_13", "(1, 3)", 3),
                          ("smollm_14_sp", "(1, 4) seq_parallel", TP_RANKS)):
        x = r0[tag]
        e_loss = abs(x["loss"] - sref["loss"]) / abs(sref["loss"])
        i, ratio = _worst_leaf(x["grad_leaf_vs_ref"],
                               sref["grad_leaf_vs_fp32"])
        x["worst_leaf"] = {"leaf": leaf_names[i], "ratio": ratio,
                           "dist": x["grad_leaf_vs_ref"][i],
                           "twin": sref["grad_leaf_vs_fp32"][i]}
        ok = (x["grad_vs_ref"] <= tol_g and ratio <= BF16_FACTOR
              and e_loss <= TRAIN_LOSS_TOL)
        x["heads"] = _head_ranges(smollm, tp)
        log(f"[tp] smollm-135m full size {B} x {S} bf16 on {mesh}, heads a "
            f"rank {x['heads']}: train "
            f"step {' / '.join(f'{v:.1f}' for v in x['step_ms'])} ms "
            f"({B * S / (x['step_ms'][-1] * 1e-3):.0f} tokens/s; unsharded "
            f"on the card {sref['step_ms']:.1f} ms); gradient vs the "
            f"unsharded bf16 one {x['grad_vs_ref']:.3e} (tol "
            f"{BF16_FACTOR:g} x its fp32 twin's {sref['grad_vs_fp32']:.3e}"
            f" = {tol_g:.3e}); worst leaf {leaf_names[i]} "
            f"{x['worst_leaf']['dist']:.3e}, {ratio:.2f} x its twin's "
            f"{x['worst_leaf']['twin']:.3e} (tol {BF16_FACTOR:g} x); loss "
            f"{x['loss']:.6f} vs "
            f"{sref['loss']:.6f} ({e_loss:.2e}, tol {TRAIN_LOSS_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}; card {card}")
        require(ok, f"phase 36: smollm-135m's sharded step on {mesh} is off "
                    f"the unsharded one")
        out[tag] = x
    x = r0["smollm_13_serve"]
    ok = (x["err"] <= tol_s and x["cache_len"] == [x["kv_len"] // 3]
          and x["worst_tie"] <= 2 * BF16_FACTOR)
    log(f"[tp] smollm-135m on (1, 3): prefill {B} x {S} "
        f"{x['prefill_ms']:.1f} ms (unsharded {sref['prefill_ms']:.1f}), "
        f"decode {x['decode_ms']:.2f} ms a step (unsharded "
        f"{sref['decode_ms']:.2f}); each rank's caches {x['cache_len']} of "
        f"{x['kv_len']} positions; logits vs the unsharded run "
        f"{x['err']:.3e} (tol {BF16_FACTOR:g} x {sref['serve_vs_fp32']:.3e}"
        f" = {tol_s:.3e}); greedy tokens agree {x['agree']} / {x['of']}, "
        f"each flip's unsharded margin {x['worst_tie']:.2f} x the twin's "
        f"row distance or less (tol {2 * BF16_FACTOR:g} x) "
        f"{'ok' if ok else 'FAIL'}; card {card}")
    require(ok, "phase 36: smollm-135m's sharded serving is off the "
                "unsharded one")
    out["smollm_13_serve"] = x
    q = [x["qwen"] for x in ranks]
    total = torch.cuda.get_device_properties(dev).total_memory
    peak = max(x["peak_bytes"] for x in q)
    ok = (r0["qwen"]["err"] <= tol_q
          and all(x["cache_len"] == [x["kv_len"] // TP_RANKS] for x in q))
    log(f"[tp] qwen2-72b full width, {qwen.n_layers} of 80 layers, on "
        f"(1, 4): prefill {Bq} x {Pq} {q[0]['prefill_ms']:.1f} ms "
        f"(unsharded {qref['prefill_ms']:.1f}), decode "
        f"{q[0]['decode_ms']:.2f} ms a step (unsharded "
        f"{qref['decode_ms']:.2f}); logits vs the unsharded run "
        f"{r0['qwen']['err']:.3e} (tol {BF16_FACTOR:g} x "
        f"{qref['serve_vs_fp32']:.3e} = {tol_q:.3e}) "
        f"{'ok' if ok else 'FAIL'}; a rank holds "
        f"{q[0]['param_bytes'] / 1e9:.3f} GB of parameters and "
        f"{q[0]['cache_bytes'] / 1e9:.4f} GB of caches ({q[0]['cache_len']} "
        f"of {q[0]['kv_len']} positions), peak {peak / 1e9:.2f} GB; four "
        f"ranks {sum(x['peak_bytes'] for x in q) / 1e9:.2f} GB against "
        f"the card's {total / 1e9:.1f} GB (each rank left "
        f"{max(x['smollm_left_bytes'] for x in ranks) / 1e9:.2f} GB or less "
        f"of smollm's stage); card {card}")
    require(ok, "phase 36: qwen2-72b's sharded serving is off the unsharded "
                "one")
    out["qwen"] = {**r0["qwen"], "ranks": q}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[tp] phase 36 took {out['phase_s']:.1f} s (the ranks "
        f"{out['ranks_s']:.1f} s)")
    return out



# ----------------------------------------------------------------------------
# Phase 37: the recurrent mixers split over "model"

#: phase 37: recurrentgemma-9b at full width, (layers kept: one period of
#: its pattern, train batch, train sequence, serve batch, prompt, decode
#: steps) on (1, 4)
TP_REC_GEMMA = (3, 2, 1_024, 2, 2_048, 8)
#: phase 37: xlstm-125m at full size, (train batch, train sequence, serve
#: batch, prompt, decode steps) on (1, 4); the sLSTM loops over time in
#: Python, so the sequence stays short
TP_REC_XLSTM = (4, 512, 4, 512, 8)
#: phase 37: each recurrent mixer at full width in fp32, split over
#: "model", against the same mixer whole on the same input, scaled: its
#: forward over TP_REC_XLSTM's sequence and a decode step after it.  The
#: bf16 rule says little of xlstm-125m, whose bf16 run sits O(1) from its
#: fp32 twin, and a whole fp32 model cannot be held either: it amplifies
#: rounding (a 1e-7 relative change of its weights moves its logits 3e-3
#: at 12 layers and 512 tokens), so each mixer is held alone.
TP_REC_FP32_TOL = 1e-4


def _tp_rec_cfgs():
    from repro_torch.configs import base as cb
    return (cb.get_config("recurrentgemma_9b").replace(
        n_layers=TP_REC_GEMMA[0]), cb.get_config("xlstm_125m"))


def _rec_cache_shapes(caches) -> dict:
    """{leaf: shape} of the recurrent decode caches (of two kinds with a
    leaf of one name, the later layer's: xlstm's last layer is an
    sLSTM)."""
    return {k: tuple(t.shape) for layer in caches for k, t in layer.items()
            if k in ("h", "conv", "C", "n", "m", "c")}


def _sq_dist(got, want, chunk: int = 1 << 26) -> tuple:
    """(‖got − want‖², ‖want‖²) in float64, ``want`` on any device, a
    chunk of ``chunk`` elements at a time (no fp32 copy of a whole
    vocabulary-sized leaf)."""
    import torch
    g, w = got.reshape(-1), want.reshape(-1)
    num = den = 0.0
    for i in range(0, g.numel(), chunk):
        b = w[i:i + chunk].to(g.device, torch.float32)
        d = g[i:i + chunk].float() - b
        num += float(torch.dot(d, d).double())
        den += float(torch.dot(b, b).double())
    return num, den


def _flip_ties(got, ref_logits, fed, twin_row, n: int) -> tuple:
    """(tokens agreeing, of, the largest flip's unsharded margin over the
    fp32 twin's distance on its row): phase 36's greedy rule."""
    want = fed.T.long()                                   # (n, B)
    ref_l = ref_logits[:n]
    pick = got[:n].argmax(-1)
    flip = pick != want
    margin = (ref_l.gather(-1, want[..., None])
              - ref_l.gather(-1, pick[..., None]))[..., 0]
    tie = (margin / twin_row[:n])[flip]
    return (int((~flip).sum()), flip.numel(),
            float(tie.max()) if tie.numel() else 0.0)


def _rank_step(cfg, opt, state, batch, want, rt):
    """One sharded train step on this rank (a process of phases 37–38):
    (loss, ms, its gradient's distance from ``want`` (the unsharded one;
    rank 0's, None elsewhere) as _rel_l2 and _leaf_rel_l2 read it).  The
    gradient, as ``sharded_grads`` returns it, is gathered whole one leaf
    at a time (every rank takes part), so no rank holds it whole."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import steps as st
    r = dist.get_rank()
    kept, sharded_grads = [], st.sharded_grads

    def keep(*a, **k):
        got = sharded_grads(*a, **k)
        kept[:] = [got[2]]
        return got
    st.sharded_grads = keep
    try:
        torch.cuda.synchronize()
        dist.barrier(group=rt.group)
        t0 = time.perf_counter()
        _, m = st.make_train_step(cfg, opt, rt=rt)(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        st.sharded_grads = sharded_grads
    shards = tree_leaves(st.wrap_shards(kept.pop(), state["params"],
                                        rt.mesh))
    ref_leaves = tree_leaves(want) if r == 0 else [None] * len(shards)
    num, den = [], []
    for t, w in zip(shards, ref_leaves):
        whole = st.full_state(t)
        if r == 0:
            a, b = _sq_dist(whole, w)
            num.append(a)
            den.append(b)
        del whole
    dists = None
    if r == 0:
        dists = (math.sqrt(sum(num) / sum(den)),
                 [math.sqrt(a / b) if b > 0 else
                  (0.0 if a == 0 else math.inf)
                  for a, b in zip(num, den)])
    return float(m["loss"]), ms, dists


def _rank_serve(cfg, params, prompt, fed, kv, steps_n, rt, extra=None):
    """This rank's prefill of ``prompt`` (and ``extra``'s leaves) and
    ``steps_n`` decode steps fed ``fed``, split over ``rt``'s "model":
    (each step's logits (steps_n + 1, B, V), {ms, caches})."""
    import torch
    import torch.distributed as dist
    from repro_torch.roofline.counts import tensor_bytes
    from repro_torch.train import steps as st
    torch.cuda.synchronize()
    dist.barrier(group=rt.group)
    t0 = time.perf_counter()
    last, caches = st.make_prefill_step(cfg, kv, rt=rt)(
        params, {"tokens": prompt, **(extra or {})})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decode = st.make_decode_step(cfg, rt=rt)
    outs = [last.float()]
    for i in range(steps_n):
        lg, caches = decode(params, caches, fed[:, i:i + 1],
                            prompt.shape[1] + i)
        outs.append(lg.float())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    info = {"prefill_ms": (t1 - t0) * 1e3,
            "decode_ms": (t2 - t1) * 1e3 / steps_n,
            "cache_bytes": tensor_bytes(caches),
            "rec_caches": _rec_cache_shapes(caches),
            "kv_lens": sorted({c[k].shape[1] for layer in caches
                               for c in layer.values()
                               if isinstance(c, dict)
                               for k in ("k", "ek") if k in c})}
    return torch.stack(outs), info


def _layer_errs(cfg, seed: int, dev, rt, layer: int, x, run, cache_of):
    """One layer's sublayer (``run(params, x, mode, cache, pos, rt)``: a
    recurrent mixer, an attention) split over ``rt``'s "model" (its
    parameters gathered as serving gathers them) against itself whole,
    fp32: the forward over x, then a prefill of x into a decode cache
    (``cache_of(rt)``, the layer's) and one decode step, scaled."""
    import torch
    from repro_torch.train import steps as st
    whole = _tp_params(cfg, seed, dev)
    ref_blk = st.model_of(cfg, whole).dec.layers()[layer]
    model, split = st._serving(cfg, st.shard_params(whole, rt.mesh), rt,
                               {"tokens": x[..., 0]})
    blk = model.dec.layers()[layer]
    S = x.shape[1]
    errs = {}
    with torch.no_grad():
        p = blk.params(split)
        errs["forward"] = scaled_err(run(p, x, "train", None, 0, split),
                                     run(ref_blk, x, "train", None, 0,
                                         None))[1]
        caches = [cache_of(q) for q in (split, None)]
        for q, c, prm in ((split, caches[0], p), (None, caches[1],
                                                   ref_blk)):
            run(prm, x, "prefill", c, 0, q)
        errs["decode"] = scaled_err(
            run(p, x[:, -1:], "decode", caches[0], S, split),
            run(ref_blk, x[:, -1:], "decode", caches[1], S, None))[1]
        errs["cache"] = {k: tuple(t.shape) for k, t in _leaves_of(
            caches[0]).items()}
    return errs


def _leaves_of(tree, path: str = "") -> dict:
    """{"a/b": tensor} of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {q: t for k, v in tree.items()
                for q, t in _leaves_of(v, f"{path}/{k}".lstrip("/")).items()}
    return {path: tree}


def _mixer_run(kind: str, cfg):
    """``_layer_errs``' ``run`` of a recurrent mixer of ``kind``."""
    from repro_torch.models import transformer as tf
    mixer = getattr(tf, f"{kind}_mixer")

    def run(p, x, mode, cache, pos, rt):
        return mixer(p, x, cfg, mode=mode, cache=cache, rt=rt)
    return run


def tp_rec_rank(out: str, seed: int, device: str) -> None:
    """Phase 37's rank (four share the card over gloo): recurrentgemma-9b
    and xlstm-125m split over "model", held by rank 0 against the
    unsharded runs (``ref.pt``; recurrentgemma's unsharded gradient rank 0
    computes itself, from the same seeded weights: 5.5 GB, not sent)."""
    import gc
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import make_lm_loader
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import (OptConfig, init_opt_state,
                                              tree_map)
    from repro_torch.roofline.counts import tensor_bytes
    from repro_torch.train import steps as st
    r = dist.get_rank()
    dev = torch.device(device)
    ref = torch.load(os.path.join(out, "ref.pt"), map_location=dev)
    res = {"err": None}
    gemma, xlstm = _tp_rec_cfgs()
    _, Bt, St, Bs, P, n_dec = TP_REC_GEMMA
    mesh = DeviceMesh(dev.type, [list(range(TP_RANKS))],
                      mesh_dim_names=("data", "model"))
    group = mesh.get_group("model")
    rt = st.make_runtime(mesh)

    def mixer_errs(cfg, layer: int, x) -> dict:
        kind = (cfg.layer_pattern * cfg.n_layers)[layer]
        return _layer_errs(
            cfg, seed, dev, rt, layer, x, _mixer_run(kind, cfg),
            lambda q: tf.init_block_cache(cfg, kind, x.shape[0],
                                          x.shape[1] + 1, device=dev, rt=q))

    try:
        # recurrentgemma-9b: two ranks at a time make the whole seeded
        # weights (5.5 GB) and keep their shards; rank 0 keeps the whole
        # weights for its unsharded gradient
        whole = None
        for i in range(0, TP_RANKS, 2):
            if i <= r < i + 2:
                whole = _tp_params(gemma, seed, dev)
                params = st.shard_params(whole, mesh)
                if r:
                    del whole
                    whole = None
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier(group=group)
        sgd = OptConfig(kind="sgd", lr=1e-3, warmup_steps=1, total_steps=10)
        batch = make_lm_loader(gemma, cb.ShapeConfig("train", St, Bt,
                                                     "train"),
                               seed=seed, device=dev)(0)
        # rank 0's unsharded gradient first, while the others hold only
        # their shards; it waits in host memory (5.5 GB) for the
        # comparison, which brings it back one leaf at a time
        g16 = None
        if r == 0:
            _, _, g16 = st.grads_of(gemma, whole, [batch])
            g16 = tree_map(lambda t: t.cpu(), g16)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier(group=group)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        state = {"params": params, "opt": init_opt_state("sgd", params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        loss, ms, dists = _rank_step(gemma, sgd, state, batch, g16, rt)
        del state, g16
        g = {"step_ms": ms, "loss": loss, "param_bytes": tensor_bytes(
            params), "base_bytes": base,
             "train_peak_bytes": torch.cuda.max_memory_allocated(dev)}
        if r == 0:
            g["grad_vs_ref"], g["grad_leaf_vs_ref"] = dists
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier(group=group)
        torch.cuda.reset_peak_memory_stats(dev)
        outs, info = _rank_serve(gemma, params, ref["gemma_prompt"],
                                 ref["gemma_fed"], ref["gemma_kv"], n_dec, rt)
        g.update(info)
        g["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if r == 0:
            g["err"] = scaled_err(outs, ref["gemma_logits"])[1]
            g["agree"], g["of"], g["worst_tie"] = _flip_ties(
                outs, ref["gemma_logits"], ref["gemma_fed"],
                ref["gemma_twin_row"], n_dec)
        res["gemma"] = g
        del params, outs
        gc.collect()
        torch.cuda.empty_cache()

        # xlstm-125m at full size (every rank makes its weights)
        Bx, Sx, Bxs, Px, nx = TP_REC_XLSTM
        adamw = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1,
                          total_steps=10)
        wx = _tp_params(xlstm, seed, dev)
        state = st.shard_state({"params": wx, "opt": init_opt_state(
            "adamw", wx), "step": torch.zeros((), dtype=torch.int32,
                                              device=dev)}, mesh)
        batch = make_lm_loader(xlstm, cb.ShapeConfig("train", Sx, Bx,
                                                     "train"),
                               seed=seed, device=dev)(0)
        loss, ms, dists = _rank_step(xlstm, adamw, state, batch,
                                     ref.pop("xlstm_g16"), rt)
        x = {"step_ms": ms, "loss": loss}
        if r == 0:
            x["grad_vs_ref"], x["grad_leaf_vs_ref"] = dists
        del state
        params = st.shard_params(wx, mesh)
        outs, info = _rank_serve(xlstm, params, ref["xlstm_prompt"],
                                 ref["xlstm_fed"], ref["xlstm_kv"], nx, rt)
        x.update(info)
        if r == 0:
            x["err"] = scaled_err(outs, ref["xlstm_logits"])[1]
            x["agree"], x["of"], x["worst_tie"] = _flip_ties(
                outs, ref["xlstm_logits"], ref["xlstm_fed"],
                ref["xlstm_twin_row"], nx)
        res["xlstm"] = x
        del params, outs, wx
        gc.collect()
        torch.cuda.empty_cache()

        # each recurrent mixer alone in fp32, split and whole, on one
        # input: recurrentgemma's RG-LRU (its first layer, the vocabulary
        # cut: the mixer never reads it), xlstm's mLSTM and sLSTM
        def noise(cfg):
            gen = torch.Generator(device=dev).manual_seed(seed + 37)
            return torch.randn((Bxs, Px, cfg.d_model), generator=gen,
                               device=dev)
        g32 = fp32_cfg(gemma).replace(n_layers=1, vocab=256)
        x32 = fp32_cfg(xlstm).replace(n_layers=len(xlstm.layer_pattern))
        res["mixers"] = {"rglru": mixer_errs(g32, 0, noise(g32)),
                         "mlstm": mixer_errs(x32, 0, noise(x32)),
                         "slstm": mixer_errs(x32, 3, noise(x32))}
    except Exception as e:  # noqa: BLE001 — reported by the parent
        import traceback
        res["err"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    torch.save(res, os.path.join(out, f"tp_rec_{r}.pt"))


def _bf16_tree_check(cfg, seed: int, dev, card: str) -> dict:
    """Fault F5's check on the card: xlstm-125m's fp32 seeded weights in
    the reference's layout (``lm_params_to_numpy``), every leaf cast to
    bf16 (the sLSTM's recurrent blocks R, the gates' biases and Λ too),
    loaded through ``lm_params_from_numpy`` and served unsharded: its
    forward finite and its decode logits no further from the fp32 forward
    of the same weights than ``BF16_FACTOR`` × its own bf16 forward is
    (phase 28's rule), beside the distance of the port's own bf16 tree
    (fp32 gates) from it."""
    import torch
    from repro_torch.models.lm import LM
    from repro_torch.util.convert import lm_params_from_numpy, \
        lm_params_to_numpy
    _, _, B, P, n = TP_REC_XLSTM
    c32 = fp32_cfg(cfg)
    m32 = LM(c32, device=dev, seed=seed)
    tree = torch.utils._pytree.tree_map(
        lambda a: torch.as_tensor(a).to(torch.bfloat16),
        lm_params_to_numpy(m32))
    m16 = lm_params_from_numpy(cfg, tree, device=dev)
    dtypes = {t.dtype for t in m16.parameters()}
    gen = torch.Generator(device=dev).manual_seed(seed + 37)
    toks = torch.randint(0, cfg.vocab, (B, P + n), generator=gen, device=dev)
    native = LM(cfg, device=dev, seed=seed)    # bf16, fp32 gates kept
    with torch.inference_mode():
        f32 = m32({"tokens": toks})[0]
        f16 = m16({"tokens": toks})[0]
        fn16 = native({"tokens": toks})[0]
        _, caches = m16.prefill({"tokens": toks[:, :P]}, kv_len=P + n)
        dec = []
        for t in range(P, P + n):
            dl, caches = m16.decode_step(caches, toks[:, t:t + 1], t)
            dec.append(dl[:, 0])
        dec = torch.stack(dec, 1)
    torch.cuda.synchronize()
    e16 = scaled_err(f16, f32)[1]
    e_native = scaled_err(fn16, f32)[1]
    e_dec = scaled_err(dec, f32[:, P:])[1]
    finite = bool(torch.isfinite(f16).all()) and bool(
        torch.isfinite(dec).all())
    ok = (dtypes == {torch.bfloat16} and finite
          and e_dec <= BF16_FACTOR * e16)
    log(f"[tp_rec] xlstm-125m from a wholesale-bf16 tree ({len(tree)} "
        f"top keys, every parameter {sorted(map(str, dtypes))}) unsharded: "
        f"forward {tuple(f16.shape)} finite {finite}, vs the fp32 forward "
        f"{e16:.3e} (the port's own bf16 tree, fp32 gates: {e_native:.3e});"
        f" prefill {B} x {P} and {n} decode steps vs the fp32 forward "
        f"{e_dec:.3e} (tol {BF16_FACTOR:g} x {e16:.3e} = "
        f"{BF16_FACTOR * e16:.3e}) {'ok' if ok else 'FAIL'}; card {card}")
    require(ok, "phase 37: the wholesale-bf16 xlstm-125m tree does not serve")
    del m16, m32, native, caches, f32, f16, fn16
    torch.cuda.empty_cache()
    return {"fwd_vs_fp32": e16, "native_fwd_vs_fp32": e_native,
            "decode_vs_fp32": e_dec, "finite": finite}


def _train_ref(cfg, seed: int, dev, B: int, S: int) -> tuple:
    """The unsharded gradient of ``cfg``'s seeded weights on a (B, S)
    batch (``make_lm_loader``'s first) on the card, and its fp32 twin's:
    (the weights, their fp32 copy, the gradient, {loss, loss32, grads_ms,
    grad_vs_fp32, grad_leaf_vs_fp32, leaves})."""
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import make_lm_loader
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train import steps as st
    params = _tp_params(cfg, seed, dev)
    batch = make_lm_loader(cfg, cb.ShapeConfig("train", S, B, "train"),
                           seed=seed, device=dev)(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss16, _, g16 = st.grads_of(cfg, params, [batch])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    p32 = tree_map(lambda t: t.float(), params)
    loss32, _, g32 = st.grads_of(fp32_cfg(cfg), p32, [batch])
    info = {"loss": float(loss16), "loss32": float(loss32),
            "grads_ms": ms, "grad_vs_fp32": _rel_l2(g16, g32),
            "grad_leaf_vs_fp32": _leaf_rel_l2(g16, g32),
            "leaves": _leaf_paths(g16)}
    del g32, batch
    torch.cuda.empty_cache()
    return params, p32, g16, info


def _serve_ref(cfg, params, p32, prompt, n: int, kv: int, ref: dict,
               tag: str, extra=None) -> dict:
    """The unsharded greedy run of ``prompt`` (``_greedy_ref``, ``n``
    steps, a cache of ``kv``) and its fp32 twin's on the same tokens:
    what the ranks need goes into ``ref`` under ``tag``; returns the
    twin's distance and the ms."""
    fed, lg16, pre, dec = _greedy_ref(cfg, params, prompt, kv, n,
                                      extra=extra)
    _, lg32, _, _ = _greedy_ref(fp32_cfg(cfg), p32, prompt, kv, n, fed=fed,
                                extra=extra)
    ref.update({f"{tag}_prompt": prompt, f"{tag}_fed": fed,
                f"{tag}_logits": lg16, f"{tag}_kv": kv,
                f"{tag}_twin_row": (lg16 - lg32).abs().amax(-1)})
    return {"serve_vs_fp32": scaled_err(lg16, lg32)[1],
            "prefill_ms": pre, "decode_ms": dec}


def phase_tp_rec(dev, seed: int, card: str) -> dict:
    """Phase 37: the recurrent mixers split over "model" on four gloo
    ranks sharing the card, as phase 36 runs them, against the unsharded
    runs on the card by phase 36's rules (``BF16_FACTOR`` × the unsharded
    bf16 run's own distance from its fp32 twin, the gradient leaf by leaf,
    a greedy flip only at a near-tie, the loss within
    ``TRAIN_LOSS_TOL``): recurrentgemma-9b at full width, depth cut to one
    period, and xlstm-125m at full size (``TP_REC_GEMMA``,
    ``TP_REC_XLSTM``), each rank's caches of the split shapes; then the
    wholesale-bf16 xlstm-125m tree (fault F5)."""
    import gc
    import tempfile
    import torch
    from repro_torch.util import dist as rdist
    t_phase = time.perf_counter()
    gemma, xlstm = _tp_rec_cfgs()
    _, Bt, St, Bs, P, n_dec = TP_REC_GEMMA
    Bx, Sx, Bxs, Px, nx = TP_REC_XLSTM
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    ref, out = {}, {"card": card}
    gen = torch.Generator(device=dev).manual_seed(seed + 37)

    def train_ref(cfg, B, S):
        return _train_ref(cfg, seed, dev, B, S)

    def serve_ref(cfg, params, p32, B, P, n, tag):
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                               device=dev)
        return _serve_ref(cfg, params, p32, prompt, n,
                          _kv_len(P, n, TP_RANKS), ref, tag)

    params, p32, g16, out["gemma_ref"] = train_ref(gemma, Bt, St)
    del g16
    out["gemma_ref"].update(serve_ref(gemma, params, p32, Bs, P, n_dec,
                                      "gemma"))
    del params, p32
    torch.cuda.empty_cache()
    params, p32, g16, out["xlstm_ref"] = train_ref(xlstm, Bx, Sx)
    ref["xlstm_g16"] = g16
    out["xlstm_ref"].update(serve_ref(xlstm, params, p32, Bxs, Px, nx,
                                      "xlstm"))
    del params, p32, g16
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_rec_") as tmp:
        torch.save(ref, os.path.join(tmp, "ref.pt"))
        ref.clear()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[tp_rec] the unsharded references took {t_ref:.1f} s; this "
            f"process holds {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB "
            f"of the card ({held / 1e9:.2f} GB allocated before the phase)")
        t_spawn = time.perf_counter()
        where = f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"
        rdist.spawn(tp_rec_rank, TP_RANKS, tmp, seed, where,
                    backend="gloo", device=where)
        out["ranks_s"] = time.perf_counter() - t_spawn
        ranks = [torch.load(os.path.join(tmp, f"tp_rec_{r}.pt"))
                 for r in range(TP_RANKS)]
    errs = [f"rank {i}: {x['err'][-1500:]}" for i, x in enumerate(ranks)
            if x["err"]]
    require(not errs, "phase 37 failed: " + "\n".join(errs))
    total = torch.cuda.get_device_properties(dev).total_memory
    want_caches = {
        "gemma": {"h": (Bs, gemma.d_model // TP_RANKS),
                  "conv": (Bs, gemma.conv_width - 1,
                           gemma.d_model // TP_RANKS)},
        "xlstm": {"C": (Bxs, xlstm.n_heads // TP_RANKS,
                        2 * xlstm.d_model // xlstm.n_heads,
                        2 * xlstm.d_model // xlstm.n_heads),
                  "m": (Bxs, xlstm.n_heads // TP_RANKS,
                        xlstm.d_model // xlstm.n_heads),
                  "c": (Bxs, xlstm.n_heads // TP_RANKS,
                        xlstm.d_model // xlstm.n_heads)}}
    names = {"gemma": f"recurrentgemma-9b full width, {gemma.n_layers} of "
                      f"38 layers,", "xlstm": "xlstm-125m full size"}
    shapes = {"gemma": (Bt, St, Bs, P, n_dec), "xlstm": (Bx, Sx, Bxs, Px,
                                                         nx)}
    for tag in ("gemma", "xlstm"):
        x, rf = ranks[0][tag], out[f"{tag}_ref"]
        e_loss = abs(x["loss"] - rf["loss"]) / abs(rf["loss"])
        i, ratio = _worst_leaf(x["grad_leaf_vs_ref"], rf["grad_leaf_vs_fp32"])
        tol_g = BF16_FACTOR * rf["grad_vs_fp32"]
        tol_s = BF16_FACTOR * rf["serve_vs_fp32"]
        caches = [y[tag]["rec_caches"] for y in ranks]
        shapes_ok = all(all(c.get(k) == v for k, v in
                            want_caches[tag].items()) for c in caches)
        ok = (x["grad_vs_ref"] <= tol_g and ratio <= BF16_FACTOR
              and e_loss <= TRAIN_LOSS_TOL and x["err"] <= tol_s
              and x["worst_tie"] <= 2 * BF16_FACTOR and shapes_ok)
        B1, S1, B2, P2, n2 = shapes[tag]
        peak = max(y[tag].get("peak_bytes", 0) for y in ranks)
        log(f"[tp_rec] {names[tag]} bf16 on (1, {TP_RANKS}): train step "
            f"{B1} x {S1} {x['step_ms']:.1f} ms (unsharded forward and "
            f"backward {rf['grads_ms']:.1f} ms; each the first of its "
            f"process at these shapes); gradient vs the unsharded "
            f"bf16 one {x['grad_vs_ref']:.3e} (tol {BF16_FACTOR:g} x its "
            f"fp32 twin's {rf['grad_vs_fp32']:.3e} = {tol_g:.3e}); worst "
            f"leaf {rf['leaves'][i]} {x['grad_leaf_vs_ref'][i]:.3e}, "
            f"{ratio:.2f} x its twin's {rf['grad_leaf_vs_fp32'][i]:.3e} "
            f"(tol {BF16_FACTOR:g} x); loss {x['loss']:.6f} vs "
            f"{rf['loss']:.6f} ({e_loss:.2e}, tol {TRAIN_LOSS_TOL:.0e}); "
            f"prefill {B2} x {P2} {x['prefill_ms']:.1f} ms (unsharded "
            f"{rf['prefill_ms']:.1f}), decode {x['decode_ms']:.2f} ms a step "
            f"(unsharded {rf['decode_ms']:.2f}); logits vs the unsharded "
            f"run {x['err']:.3e} (tol {BF16_FACTOR:g} x "
            f"{rf['serve_vs_fp32']:.3e} = {tol_s:.3e}); greedy tokens agree "
            f"{x['agree']} / {x['of']}, each flip's unsharded margin "
            f"{x['worst_tie']:.2f} x the twin's row distance or less (tol "
            f"{2 * BF16_FACTOR:g} x); each rank's recurrent caches "
            f"{caches[0]}, attention caches {x['kv_lens']} positions"
            + (f"; a rank holds {x['param_bytes'] / 1e9:.3f} GB of "
               f"parameters, peak in the train step "
               f"{max(y[tag]['train_peak_bytes'] for y in ranks) / 1e9:.2f}"
               f" GB, in serving {peak / 1e9:.2f} GB (four ranks "
               f"{sum(y[tag]['peak_bytes'] for y in ranks) / 1e9:.2f} GB of "
               f"the card's {total / 1e9:.1f} GB)" if tag == "gemma" else "")
            + f" {'ok' if ok else 'FAIL'}; card {card}")
        require(ok, f"phase 37: {names[tag]} split over model is off the "
                    f"unsharded run")
        out[tag] = {**x, "ranks": [y[tag] for y in ranks]}
    mix = [y["mixers"] for y in ranks]
    worst = max(e[k] for m in mix for e in m.values()
                for k in ("forward", "decode"))
    ok = worst <= TP_REC_FP32_TOL
    log(f"[tp_rec] each mixer alone, fp32, full width, {Bxs} x {Px} on (1, "
        f"{TP_RANKS}) against itself whole (forward; decode step after a "
        f"prefill): " + "; ".join(
            f"{k} {mix[0][k]['forward']:.3e} / {mix[0][k]['decode']:.3e}, "
            f"rank 0's cache {mix[0][k]['cache']}" for k in mix[0])
        + f"; worst over the ranks {worst:.3e} (tol {TP_REC_FP32_TOL:.0e})"
        f" {'ok' if ok else 'FAIL'}; card {card}")
    require(ok, "phase 37: a recurrent mixer split over model is off the "
                "whole one")
    out["mixers"] = mix
    out["bf16_tree"] = _bf16_tree_check(xlstm, seed, dev, card)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[tp_rec] phase 37 took {out['phase_s']:.1f} s (the ranks "
        f"{out['ranks_s']:.1f} s)")
    return out


# ----------------------------------------------------------------------------
# Phase 38: attention and xLSTM cells whose heads do not divide "model"

#: phase 38: the ranks of "model" (gloo processes sharing the card), where
#: yi-34b's 56 heads split 19 / 19 / 18, whisper-base's 8 split 3 / 3 / 2
#: and xlstm-125m's 4 split 2 / 1 / 1 (``sharding.head_range``)
TP_HEADS_RANKS = 3
#: phase 38: yi-34b at full width, (layers kept, batch, prompt, decode
#: steps)
TP_HEADS_YI = (2, 2, 2_048, 8)
#: phase 38: whisper-base at full size, (batch, prompt, encoder frames,
#: decode steps); attn_chunk 500 for the 1,500 frames (phase 27's cut)
TP_HEADS_WHISPER = (2, 64, 1_500, 8)
#: phase 38: the uneven attention layers alone in fp32, (batch, sequence)
TP_HEADS_LAYER = (2, 512)
#: phase 38: a gradient leaf whose unsharded bf16 value lies this far
#: (relative L2) or farther from its fp32 twin's carries rounding only,
#: and is held by the whole gradient's rule, not leaf by leaf: xlstm-125m's
#: input-gate biases, whose gradient the gates' stabiliser makes zero up
#: to rounding (exactly zero in the sLSTM; ROADMAP.md §3)
NOISE_LEAF = 0.5


def _tp_heads_cfgs():
    from repro_torch.configs import base as cb
    return (cb.get_config("yi_34b").replace(n_layers=TP_HEADS_YI[0]),
            cb.get_config("whisper_base").replace(attn_chunk=500),
            cb.get_config("xlstm_125m"))


def _head_ranges(cfg, tp: int) -> list:
    from repro_torch.distributed.sharding import head_range
    return [head_range(cfg.n_heads, tp, r) for r in range(tp)]


def _kv_read(cfg, tp: int) -> list:
    """The KV heads [lo, hi) each rank's query heads read."""
    from repro_torch.models.attention import kv_heads_of
    return [kv_heads_of(h0, h1 - h0, cfg.n_heads // cfg.n_kv)
            for h0, h1 in _head_ranges(cfg, tp)]


def tp_heads_rank(out: str, seed: int, device: str) -> None:
    """Phase 38's rank (three share the card over gloo): yi-34b,
    whisper-base and xlstm-125m on their whole heads, split unevenly over
    "model", held by rank 0 against the unsharded runs (``ref.pt``); then
    each uneven layer alone in fp32 against itself whole."""
    import gc
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import make_lm_loader
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import OptConfig, init_opt_state
    from repro_torch.roofline.counts import tensor_bytes
    from repro_torch.train import steps as st
    r = dist.get_rank()
    dev = torch.device(device)
    ref = torch.load(os.path.join(out, "ref.pt"), map_location=dev)
    res = {"err": None}
    yi, whisper, xlstm = _tp_heads_cfgs()
    mesh = DeviceMesh(dev.type, [list(range(TP_HEADS_RANKS))],
                      mesh_dim_names=("data", "model"))
    rt = st.make_runtime(mesh)

    def served(cfg, tag, n, extra=None):
        whole = _tp_params(cfg, seed, dev)
        params = st.shard_params(whole, mesh)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        outs, info = _rank_serve(cfg, params, ref[f"{tag}_prompt"],
                                 ref[f"{tag}_fed"], ref[f"{tag}_kv"], n, rt,
                                 extra)
        info.update(param_bytes=tensor_bytes(params),
                    peak_bytes=torch.cuda.max_memory_allocated(dev))
        if r == 0:
            info["err"] = scaled_err(outs, ref[f"{tag}_logits"])[1]
            info["agree"], info["of"], info["worst_tie"] = _flip_ties(
                outs, ref[f"{tag}_logits"], ref[f"{tag}_fed"],
                ref[f"{tag}_twin_row"], n)
        del params, outs
        gc.collect()
        torch.cuda.empty_cache()
        return info

    try:
        res["yi"] = served(yi, "yi", TP_HEADS_YI[3])
        res["whisper"] = served(whisper, "whisper", TP_HEADS_WHISPER[3],
                                {"enc_frames": ref["whisper_frames"]})
        # xlstm-125m: one train step, then serving
        Bx, Sx, Bxs, Px, nx = TP_REC_XLSTM
        adamw = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1,
                          total_steps=10)
        wx = _tp_params(xlstm, seed, dev)
        state = st.shard_state({"params": wx, "opt": init_opt_state(
            "adamw", wx), "step": torch.zeros((), dtype=torch.int32,
                                              device=dev)}, mesh)
        del wx
        batch = make_lm_loader(xlstm, cb.ShapeConfig("train", Sx, Bx,
                                                     "train"),
                               seed=seed, device=dev)(0)
        loss, ms, dists = _rank_step(xlstm, adamw, state, batch,
                                     ref.pop("xlstm_g16"), rt)
        del state
        res["xlstm"] = {"step_ms": ms, "loss": loss, **served(xlstm, "xlstm",
                                                              nx)}
        if r == 0:
            res["xlstm"]["grad_vs_ref"], res["xlstm"]["grad_leaf_vs_ref"] = \
                dists

        # each uneven layer alone in fp32, split and whole, on one input:
        # yi's attention, whisper's cross-attention, xlstm's mixers
        gen = torch.Generator(device=dev).manual_seed(seed + 38)

        def noise(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        B, S = TP_HEADS_LAYER
        y32 = fp32_cfg(yi).replace(n_layers=1, vocab=256)
        w32 = fp32_cfg(whisper).replace(vocab=256)
        x32 = fp32_cfg(xlstm).replace(n_layers=len(xlstm.layer_pattern))
        kv = _kv_len(S, 1, TP_HEADS_RANKS)
        Bw, Pw, Fw, _ = TP_HEADS_WHISPER
        ctx = noise(Bw, Fw, w32.d_model)

        def attn(p, x, mode, cache, pos, q):
            return tf._self_attention(
                p["attn"], x, y32, causal=True, window=0, mode=mode,
                cache=None if cache is None else cache["self"], pos=pos,
                rt=q)

        def xattn(p, x, mode, cache, pos, q):
            return tf._cross_attention(
                p["xattn"], x, w32, ctx=ctx, mode=mode,
                cache=None if cache is None else cache["cross"], rt=q)
        xs = noise(Bxs, Px, x32.d_model)
        res["layers"] = {
            "yi attention": _layer_errs(
                y32, seed, dev, rt, 0, noise(B, S, y32.d_model), attn,
                lambda q: tf.init_block_cache(y32, "attn", B, kv,
                                              device=dev, rt=q)),
            "whisper cross-attention": _layer_errs(
                w32, seed, dev, rt, 0, noise(Bw, Pw, w32.d_model), xattn,
                lambda q: {"cross": tf.init_block_cache(
                    w32, "attn_cross", Bw, Pw + 1, Fw, device=dev,
                    rt=q)["cross"]}),
            **{f"xlstm {kind}": _layer_errs(
                x32, seed, dev, rt, layer, xs, _mixer_run(kind, x32),
                lambda q, kind=kind: tf.init_block_cache(
                    x32, kind, Bxs, Px + 1, device=dev, rt=q))
               for kind, layer in (("mlstm", 0), ("slstm", 3))}}
    except Exception as e:  # noqa: BLE001 — reported by the parent
        import traceback
        res["err"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    torch.save(res, os.path.join(out, f"tp_heads_{r}.pt"))


def phase_tp_heads(dev, seed: int, card: str) -> dict:
    """Phase 38: attention and the xLSTM cells on each rank's whole heads
    where the heads do not divide "model" (``sharding.head_range``), on
    three gloo ranks sharing the card, as phases 36–37 run them, against
    the unsharded runs on the card by their rules (``BF16_FACTOR`` × the
    unsharded bf16 run's own distance from its fp32 twin, the gradient
    leaf by leaf, a greedy flip only at a near-tie, the loss within
    ``TRAIN_LOSS_TOL``): yi-34b at full width, depth cut to
    ``TP_HEADS_YI``'s layers (heads 19 / 19 / 18), whisper-base at full
    size (3 / 3 / 2 in its encoder, self- and cross-attention), prefill
    and decode; xlstm-125m at full size (2 / 1 / 1), a train step,
    prefill and decode; then each uneven layer alone in fp32 against
    itself whole within ``TP_REC_FP32_TOL``."""
    import gc
    import tempfile
    import torch
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.util import dist as rdist
    t_phase = time.perf_counter()
    yi, whisper, xlstm = _tp_heads_cfgs()
    _, By, Py, ny = TP_HEADS_YI
    Bw, Pw, Fw, nw = TP_HEADS_WHISPER
    Bx, Sx, Bxs, Px, nx = TP_REC_XLSTM
    tp = TP_HEADS_RANKS
    gc.collect()
    torch.cuda.empty_cache()
    ref, out = {}, {"card": card}
    gen = torch.Generator(device=dev).manual_seed(seed + 38)

    def served_ref(cfg, tag, B, P, n, extra=None):
        params = _tp_params(cfg, seed, dev)
        p32 = tree_map(lambda t: t.float(), params)
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                               device=dev)
        info = _serve_ref(cfg, params, p32, prompt, n, _kv_len(P, n, tp),
                          ref, tag, extra)
        del params, p32
        gc.collect()
        torch.cuda.empty_cache()
        return info

    out["yi_ref"] = served_ref(yi, "yi", By, Py, ny)
    ref["whisper_frames"] = 0.1 * torch.randn(
        (Bw, Fw, whisper.d_model), generator=gen, device=dev)
    out["whisper_ref"] = served_ref(whisper, "whisper", Bw, Pw, nw,
                                    {"enc_frames": ref["whisper_frames"]})
    params, p32, g16, out["xlstm_ref"] = _train_ref(xlstm, seed, dev, Bx,
                                                    Sx)
    ref["xlstm_g16"] = g16
    prompt = torch.randint(0, xlstm.vocab, (Bxs, Px), generator=gen,
                           device=dev)
    out["xlstm_ref"].update(_serve_ref(xlstm, params, p32, prompt, nx,
                                       _kv_len(Px, nx, tp), ref, "xlstm"))
    del params, p32, g16
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_heads_") as tmp:
        torch.save(ref, os.path.join(tmp, "ref.pt"))
        ref.clear()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[tp_heads] the unsharded references took {t_ref:.1f} s")
        t_spawn = time.perf_counter()
        where = f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"
        rdist.spawn(tp_heads_rank, tp, tmp, seed, where, backend="gloo",
                    device=where)
        out["ranks_s"] = time.perf_counter() - t_spawn
        ranks = [torch.load(os.path.join(tmp, f"tp_heads_{r}.pt"))
                 for r in range(tp)]
    errs = [f"rank {i}: {x['err'][-1500:]}" for i, x in enumerate(ranks)
            if x["err"]]
    require(not errs, "phase 38 failed: " + "\n".join(errs))
    r0 = ranks[0]
    # the KV lengths each rank's caches hold: self-attention kv / tp,
    # whisper's cross-attention its frames / tp
    want_kv = {"yi": [_kv_len(Py, ny, tp) // tp],
               "whisper": sorted({_kv_len(Pw, nw, tp) // tp, Fw // tp}),
               "xlstm": []}
    dh = 2 * xlstm.d_model // xlstm.n_heads
    ds = xlstm.d_model // xlstm.n_heads
    names = {"yi": f"yi-34b full width, {yi.n_layers} of 60 layers,",
             "whisper": "whisper-base full size", "xlstm": "xlstm-125m "
             "full size"}
    shapes = {"yi": f"{By} x {Py}", "whisper": f"{Bw} x {Pw} ({Fw} encoder "
              f"frames)", "xlstm": f"{Bxs} x {Px}"}
    for tag, cfg in (("yi", yi), ("whisper", whisper), ("xlstm", xlstm)):
        x, rf = r0[tag], out[f"{tag}_ref"]
        heads = _head_ranges(cfg, tp)
        tol_s = BF16_FACTOR * rf["serve_vs_fp32"]
        ok = (x["err"] <= tol_s and x["worst_tie"] <= 2 * BF16_FACTOR
              and all(y[tag]["kv_lens"] == want_kv[tag] for y in ranks))
        msg = (f"[tp_heads] {names[tag]} bf16 on (1, {tp}), heads a rank "
               f"{heads}")
        if tag == "yi":
            msg += f", KV heads read {_kv_read(cfg, tp)}"
        if tag == "xlstm":
            want = [{"C": (Bxs, h1 - h0, dh, dh), "c": (Bxs, h1 - h0, ds)}
                    for h0, h1 in heads]
            caches = [y[tag]["rec_caches"] for y in ranks]
            shapes_ok = all(all(c.get(k) == v for k, v in w.items())
                            for c, w in zip(caches, want))
            e_loss = abs(x["loss"] - rf["loss"]) / abs(rf["loss"])
            twin = rf["grad_leaf_vs_fp32"]
            held = [j for j, t in enumerate(twin) if t < NOISE_LEAF]
            noise = [j for j in range(len(twin)) if j not in held]
            require(held, "phase 38: no xlstm-125m gradient leaf within "
                          f"{NOISE_LEAF:g} of its fp32 twin")
            i, ratio = _worst_leaf([x["grad_leaf_vs_ref"][j] for j in held],
                                   [twin[j] for j in held])
            i = held[i]
            tol_g = BF16_FACTOR * rf["grad_vs_fp32"]
            ok = (ok and shapes_ok and x["grad_vs_ref"] <= tol_g
                  and ratio <= BF16_FACTOR and e_loss <= TRAIN_LOSS_TOL)
            msg += (f": train step {Bx} x {Sx} {x['step_ms']:.1f} ms "
                    f"(unsharded forward and backward {rf['grads_ms']:.1f} "
                    f"ms); gradient vs the unsharded bf16 one "
                    f"{x['grad_vs_ref']:.3e} (tol {BF16_FACTOR:g} x its fp32 "
                    f"twin's {rf['grad_vs_fp32']:.3e} = {tol_g:.3e}); worst "
                    f"leaf {rf['leaves'][i]} {x['grad_leaf_vs_ref'][i]:.3e}, "
                    f"{ratio:.2f} x its twin's "
                    f"{rf['grad_leaf_vs_fp32'][i]:.3e} (tol {BF16_FACTOR:g} "
                    f"x) over the {len(held)} of {len(twin)} leaves within "
                    f"{NOISE_LEAF:g} of their twins (the other "
                    f"{len(noise)} rounding only, at most "
                    f"{max((x['grad_leaf_vs_ref'][j] for j in noise),
                           default=0):.3e} "
                    f"from the unsharded bf16 leaf; twins "
                    f"{min((twin[j] for j in noise), default=0):.3e}–"
                    f"{max((twin[j] for j in noise), default=0):.3e}); loss "
                    f"{x['loss']:.6f} vs {rf['loss']:.6f} "
                    f"({e_loss:.2e}, tol {TRAIN_LOSS_TOL:.0e}); each rank's "
                    f"recurrent caches {caches}")
        peak = max(y[tag]["peak_bytes"] for y in ranks)
        log(msg + f"; prefill {shapes[tag]} {x['prefill_ms']:.1f} ms "
            f"(unsharded {rf['prefill_ms']:.1f}), decode "
            f"{x['decode_ms']:.2f} ms a step (unsharded "
            f"{rf['decode_ms']:.2f}); logits vs the unsharded run "
            f"{x['err']:.3e} (tol {BF16_FACTOR:g} x {rf['serve_vs_fp32']:.3e}"
            f" = {tol_s:.3e}); greedy tokens agree {x['agree']} / "
            f"{x['of']}, each flip's unsharded margin {x['worst_tie']:.2f} x "
            f"the twin's row distance or less (tol {2 * BF16_FACTOR:g} x); "
            f"each rank's KV caches {x['kv_lens']} positions; a rank holds "
            f"{x['param_bytes'] / 1e9:.3f} GB of parameters, peak serving "
            f"{peak / 1e9:.2f} GB {'ok' if ok else 'FAIL'}; card {card}")
        require(ok, f"phase 38: {names[tag]} on uneven heads is off the "
                    f"unsharded run")
        out[tag] = {**x, "heads": heads, "ranks": [y[tag] for y in ranks]}
    layers = [y["layers"] for y in ranks]
    worst = max(e[k] for m in layers for e in m.values()
                for k in ("forward", "decode"))
    ok = worst <= TP_REC_FP32_TOL
    log(f"[tp_heads] each uneven layer alone, fp32, full width, on (1, "
        f"{tp}) against itself whole (forward; decode step after a "
        f"prefill): " + "; ".join(
            f"{k} {layers[0][k]['forward']:.3e} / "
            f"{layers[0][k]['decode']:.3e}, rank 0's cache "
            f"{layers[0][k]['cache']}" for k in layers[0])
        + f"; worst over the ranks {worst:.3e} (tol {TP_REC_FP32_TOL:.0e}) "
        f"{'ok' if ok else 'FAIL'}; card {card}")
    require(ok, "phase 38: an uneven layer split over model is off the "
                "whole one")
    out["layers"] = layers
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[tp_heads] phase 38 took {out['phase_s']:.1f} s (the ranks "
        f"{out['ranks_s']:.1f} s)")
    return out


def phase_dryrun_phases(dev, seed: int, card: str, prefill_ms=None,
                        train_ms=None) -> dict:
    """Phases 33 (models), 34 and 35 in order."""
    out = {"count_models": phase_count_models(dev, seed, card, prefill_ms,
                                              train_ms),
           "dryrun": phase_dryrun(card),
           "pipeline": phase_pipeline(dev, card)}
    out["phase_s"] = sum(v["phase_s"] for v in out.values())
    return out


def direct_rel_error(A, W, H, rows: int = 32_768) -> float:
    """||A − WH||_F / ||A||_F without the trace trick, in row chunks (a
    check only: torch.matmul in fp32 whatever A's and the factors' dtype,
    fp64 sums)."""
    import torch
    num = torch.zeros((), dtype=torch.float64, device=A.device)
    den = torch.zeros((), dtype=torch.float64, device=A.device)
    for r0 in range(0, A.shape[0], rows):
        blk = A[r0:r0 + rows].float()
        diff = blk - W[r0:r0 + rows].float() @ H.float()
        num += (diff * diff).sum(dtype=torch.float64)
        den += (blk * blk).sum(dtype=torch.float64)
    return float((num / den).sqrt())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=M_FULL,
                    help="rows of A; cut only if the time limit forces it")
    ap.add_argument("--sparse-dim", type=int, default=SPARSE_DIM,
                    help="rows and columns of the sparse matrix; cut only "
                         "if the time limit forces it")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.backends import SparseOps
    from repro_torch.data.pipeline import lowrank_matrix
    torch.backends.cuda.matmul.allow_tf32 = False   # exact fp32 references
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = phase_card()
    phase_build()

    dev = torch.device("cuda", 0)
    m, n = args.m, N_FULL
    if m != M_FULL:
        log(f"[data] cut: m = {m} of the Video shape's {M_FULL}")
    new_phases = {"video_generator": phase_video_generator(dev, args.seed + 1,
                                                            m, n)}
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    A = lowrank_matrix(gen, m, n, K, noise=NOISE)
    Ht = torch.rand((n, K), generator=gen, device=dev)
    W = torch.rand((m, K), generator=gen, device=dev)
    torch.cuda.synchronize()
    log(f"[data] A {tuple(A.shape)} fp32 = {A.numel() * 4 / 1e9:.2f} GB, "
        f"rank {K} + {NOISE}·U, in {time.perf_counter() - t0:.2f} s")

    errs: dict = {}
    phase_kernels(A, Ht, W, errs)
    phase_small()
    timings = phase_timings(A, Ht, W, errs)
    del Ht, W
    torch.cuda.empty_cache()
    timings.update(phase_luc(dev, LUC_RAGGED + ((m, K),), errs, "video", m,
                             MU_TIMED_KS))
    launches, summary, res_bpp = phase_main(
        A, args.seed, (("bpp", 10), ("mu", 3), ("hals", 3)))
    counts, summary["accel"] = phase_accel(A, args.seed,
                                           (("amu", 3), ("ahals", 3)))
    add_launches(launches, counts)
    summary["breakdown_ms"] = phase_breakdown(
        A, args.seed, (("bpp", 2), ("mu", 3), ("hals", 3), ("amu", 3),
                       ("ahals", 3)))
    counts, summary["serve"] = phase_serve_dense(A, res_bpp)
    add_launches(launches, counts)
    del res_bpp
    torch.cuda.empty_cache()
    counts, new_phases["profile"], res_mu = phase_profile(
        A, args.seed, (("mu", 3), ("hals", 3)), card)
    add_launches(launches, counts)
    new_phases["generators"] = phase_generators_and_checkpoints(
        dev, args.seed, res_mu)
    counts, new_phases["batcher"] = phase_batcher(A, res_mu)
    add_launches(launches, counts)
    counts, new_phases["mesh"] = phase_mesh(A, res_mu)
    add_launches(launches, counts)
    del res_mu
    torch.cuda.empty_cache()
    new_s = sum(v["phase_s"] for v in new_phases.values())
    log(f"[profile] phases 19–22 took {new_s:.1f} s")
    summary["phases_19_22"] = new_phases
    counts, summary["wide"], wide = phase_wide(A, args.seed, errs)
    add_launches(launches, counts)
    timings["hals_sweep_wide"] = wide.pop("hals_sweep_wide")
    for name, row in wide.items():
        timings[name].update({f"{key}_k{K_WIDE}": v
                              for key, v in row.items()})
    counts, summary["schedules"] = phase_schedules(
        A, args.seed, (("faun", "mu", 3, {}), ("faun", "hals", 3, {}),
                       ("faun", "bpp", 1, {}), ("naive", "mu", 3, {})),
        card, "schedules")
    add_launches(launches, counts)
    t_new = time.perf_counter()
    counts, summary["compressed"] = phase_compressed(
        A, args.seed, (("faun", "mu", 3, {}, "dense"),
                       ("faun", "hals", 3, {}, "dense"),
                       ("faun", "bpp", 1, {}, "dense"),
                       ("naive", "mu", 3, {}, "dense")),
        card, "compressed", direct_rel_error)
    add_launches(launches, counts)
    counts, summary["gspmd"] = phase_gspmd(
        A, args.seed, (("mu", 3, "cuda", {}), ("hals", 3, "cuda", {}),
                       ("mu", 3, "dense", {"backend": "dense"}),
                       ("hals", 3, "dense", {"backend": "dense"})),
        card, "gspmd")
    add_launches(launches, counts)
    added_s = time.perf_counter() - t_new
    log(f"[gspmd] phases 17 and 18 on Video took {added_s:.1f} s")
    counts, summary["elastic"] = phase_elastic(A, args.seed, card)
    add_launches(launches, counts)
    counts, summary["count"] = phase_count_nmf(A, args.seed, card)
    add_launches(launches, counts)
    del A
    torch.cuda.empty_cache()
    summary["grid"] = phase_grid(dev, args.seed, (("mu", 3), ("hals", 3)),
                                 card, compressed=(("mu", 3), ("hals", 3)))
    counts, summary["mixed"], mixed = phase_mixed(dev, args.seed, m, n, errs)
    add_launches(launches, counts)
    timings.update(mixed)
    counts, summary["online"] = phase_online(dev, args.seed, card)
    add_launches(launches, counts)
    late_s = sum(summary[key]["phase_s"]
                 for key in ("elastic", "mixed", "online"))
    log(f"[online] phases 23–25 took {late_s:.1f} s")
    summary["models"] = phase_models_reduced(dev, args.seed)
    smollm, summary["smollm"] = phase_smollm(dev, args.seed)
    summary["full_width"] = phase_full_width(dev, args.seed)
    counts, summary["compress"], compress = phase_weight_compress(
        smollm, args.seed, errs)
    add_launches(launches, counts)
    for name, row in compress.items():
        timings[name].update(row)
    del smollm
    torch.cuda.empty_cache()
    model_s = sum(summary[key]["phase_s"]
                  for key in ("models", "smollm", "full_width", "compress"))
    log(f"[compress] phases 26–28 took {model_s:.1f} s")
    summary["train"] = phase_train(dev, args.seed)
    summary["dryrun"] = phase_dryrun_phases(
        dev, args.seed, card, min(summary["smollm"]["prefill_ms"]),
        summary["train"]["smollm"]["ms_per_step"])
    log(f"[dryrun] phases 33–35 took "
        f"{summary['count']['phase_s'] + summary['dryrun']['phase_s']:.1f} s")
    summary["tp"] = phase_tp(dev, args.seed, card)
    summary["tp_rec"] = phase_tp_rec(dev, args.seed, card)
    summary["tp_heads"] = phase_tp_heads(dev, args.seed, card)

    if args.sparse_dim != SPARSE_DIM:
        log(f"[data] cut: sparse m = n = {args.sparse_dim} of {SPARSE_DIM}")
    sp = phase_sparse_data(dev, args.seed, args.sparse_dim)
    phase_sparse_kernels(sp["blk"], errs)
    timings.update(phase_sparse_timings(sp["blk"], sp["srt"], errs))
    for name, row in phase_luc(dev, ((args.sparse_dim, K),), errs,
                               "webbase", args.sparse_dim).items():
        timings[name].update({f"{key}_sparse": v for key, v in row.items()})
    counts, sp_summary, res_mu = phase_sparse_main(
        sp["blk"], sp["srt"], args.seed,
        (("mu", 3, "sorted"), ("mu", 3, "auto"), ("hals", 3, "sorted"),
         ("hals", 3, "auto"), ("bpp", 1, "sorted")))
    add_launches(launches, counts)
    counts, sp_summary["serve"] = phase_serve_sparse(res_mu, args.sparse_dim,
                                                     args.seed)
    add_launches(launches, counts)
    del res_mu
    torch.cuda.empty_cache()
    counts, sp_summary["accel"] = phase_accel(
        sp["srt"], args.seed, (("ahals", 2),),
        backend=SparseOps(spmm_impl="sorted"), label="sparse accel")
    add_launches(launches, counts)
    counts, sp_summary["schedules"] = phase_schedules(
        sp["srt"], args.seed,
        (("faun", "mu", 2, {"backend": SparseOps(spmm_impl="sorted")}),),
        card, "sparse schedules")
    add_launches(launches, counts)
    counts, auto = phase_schedules(
        sp["blk"], args.seed,
        (("faun", "mu", 2, {"backend": SparseOps(spmm_impl="auto")}),),
        card, "sparse schedules", exact=False)
    add_launches(launches, counts)
    sp_summary["schedules"].update(auto)
    t_new = time.perf_counter()
    counts, sp_summary["compressed"] = phase_compressed(
        sp["srt"], args.seed,
        (("faun", "mu", 2, {"backend": SparseOps(spmm_impl="sorted")},
          "sparse"),),
        card, "sparse compressed", direct_sparse_rel_error)
    add_launches(launches, counts)
    counts, sp_summary["gspmd"] = phase_gspmd(
        sp["blk"], args.seed,
        (("mu", 2, "sparse", {"backend": SparseOps(spmm_impl="auto")}),),
        card, "sparse gspmd")
    add_launches(launches, counts)
    sparse_added_s = time.perf_counter() - t_new
    log(f"[sparse gspmd] phases 17 and 18 on the sparse A took "
        f"{sparse_added_s:.1f} s")
    summary["added_phases_s"] = {"video": added_s, "sparse": sparse_added_s}
    sp_summary["breakdown_ms"] = phase_sparse_breakdown(
        sp["blk"], sp["srt"], args.seed,
        (("mu", 2, "sorted"), ("mu", 2, "auto"), ("hals", 2, "sorted"),
         ("hals", 2, "auto"), ("amu", 2, "sorted"), ("ahals", 2, "sorted")))
    summary["sparse"] = {"shape": sp["blk"].shape, "nnz": sp["blk"].nnz,
                         "sort_s": sp["sort_s"], "fits": sp_summary}
    del sp
    torch.cuda.empty_cache()
    summary["smollm"].update(phase_decode_profile(
        dev, args.seed, summary["smollm"]["decode_ms_per_step"][-1]))

    kernels = [{"name": name, "route": "cuda", **KERNELS[name],
                "launches": launches[name], "max_abs_err": errs[name][0],
                "max_err": errs[name][1], **timings[name],
                "kernel_ms": timings[name]["ms"]}
               for name in KERNELS]
    require(all(kv["launches"] > 0 for kv in kernels), "a kernel never ran")
    log(f"[done] {time.perf_counter() - t_start:.1f} s; card {card}")
    log(json.dumps({"main": summary}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

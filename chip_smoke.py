#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure (non-zero exit, no result line), each
followed by its seconds:
  1. device  — name, count, torch/CUDA versions, ``nvidia-smi`` name and
               power limit, SM count and L2 size against the machine file;
  2. build   — the six CUDA sources from ``src/repro_torch/csrc`` with
               nvcc for sm_90a, in parallel; build seconds, the ptxas
               report (registers, spills) of every kernel instantiation
               (the head-dim-256 ones, every backward instantiation and
               every stencil instantiation must not spill), the backward
               library's shared bytes and threads against
               ``backward_smem_bytes``, the advisor's stencil plans (shared bytes,
               threads) against each stencil library's
               ``repro_<kernel>_limits`` at the main-path and ragged
               shapes, the count of HGMMA
               (tensor-core) instructions in each flash library's SASS
               (``cuobjdump -sass``, positive for both tensor-core
               libraries), and the launch limits of every wgmma and bf16x3
               instantiation as the library states them against
               ``launch_limits``, at the instantiated head dims and at 112
               (padded to 128); the registers and spills of every
               CUDA-core instantiation (the tiled kernel at each triple
               of ``SIMT_TILED_SET`` and the general kernel, both types;
               none may spill, nor hold fewer CTAs an SM than
               ``launch_limits`` says) and the simt library's launch
               limits against ``_simt_limits`` at every triple the smoke
               launches on simt;
  3. check   — each kernel against its plain PyTorch version on the card,
               at the reference tolerances: the stencils at ragged shapes,
               at the ring's edges (N below one tile, M <= 2r, M below
               the stages) and at the main-path shape, each printing its
               launch plan (boundaries bit-exact); the
               bf16x3 split pass bit-exact against ``plain_split``; flash
               attention on all three routes — bf16 on the tensor cores
               ("wgmma"), f32 on the tensor cores as three bf16 passes
               ("bf16x3"), and both types off those sets on the CUDA cores
               ("simt": blocks ``SIMT_BLOCKS``, head_dim 100, and
               ``SIMT_CASES`` forced onto simt, causal and full, at two
               q_offsets: head dims 4, 100, 136, 264, blocks 4, 48, 116,
               the tiled triples) — at head_dim
               32/64/96/128/256 and 40/112/136 (padded), causal and full,
               the decode shape (1, 32, 128, 4096), padded q blocks
               (16, 32), and every feasible candidate of the seq-256 tune
               spaces, in both types; each case prints the route whose
               launch counter moved, and the worst error is kept per
               (route, dtype); then the backward kernel
               (``flash_attention_backward``, ``csrc/flash_attention_bwd.cu``)
               against ``attention_backward`` at granite-8b's (1, 32,
               4096, 128), zamba2-7b's head dim 112 (padded), phi-3's 96,
               10a's 32 at 64 rows, a causal call with sq < skv and
               q_offset > 0, one whose last q rows carry zero dO and one
               with an odd number of 64-row kv blocks (each of dQ, dK and
               dV within FA_TOL[bf16] of its largest entry), each run
               twice with bitwise-equal results, and its time at
               granite's shape beside ``attention_backward``, SDPA's
               forward plus backward, SDPA's backward alone and
               ``attention_backward_bound``, with each launch's ms (rows
               pass, fused pass, dQ cast) from ``torch.profiler``;
  4. main    — the stencil case study at full size: the 7-point stencil at
               (512, 512, 512) and the long-range stencil at the paper's §3
               size (130, 1015, 1015), fp32.  Per stencil: ECM and Roofline
               prediction on the H100 machine file, a run through the
               ``ops`` wrappers, the launch plan (tile, points per thread,
               stages, CTAs and bytes in flight per SM), CUDA-event
               timing, a ``copy_`` of the same bytes, the plain version's
               and (7-point) ``conv3d``'s times, and the HBM bound;
  4b. stencil tune — ``tune stencil3d7pt`` and ``tune longrange3d`` on the
               H100 machine file at their defaults: predict every block
               edge through ``grid_search``'s compiled plan at 132 cores,
               measure the top 5 (the top 4 and the default at least) in
               child processes on the CUDA kernels, write the calibration
               into the copy of the machine file under ``build/``, and
               print each candidate's predicted and measured time,
               ``rms_log`` before and after calibration, the chosen block
               edge against the default, and one run of the chosen
               candidate in this process (its launches counted, held
               against the plain version); then where ``grid_search``
               changes regime at 132 SMs, ``lc_block_size`` per
               level of the machine file for both traced kernels and the
               paper's C long-range listing, and ECM at phase 4's
               full-size shapes from the calibrated copy beside phase 4's
               uncalibrated figures;
  4c. SIM and ports — host analysis only, no launch: per main-path
               stencil traced at 4 bytes at phase 4's shape, bytes per
               iteration per level from LC at 132 SMs, from the cache
               simulator at the JAX default warm-up (2 rows), at a
               256-row probe, and at a warm-up covering the 3D layer
               condition (2N + 2 rows, 7-point; 8N + 2, long-range), cut
               to the rows the probe says fit the phase's 30 s (the rows
               run are printed), each with its host seconds; ECM and
               Roofline from each beside phase 4's measured time
               (measured/predicted); the ``ports`` in-core model against
               ``simple`` at SP and at the DP default (T_OL, T_nOL, T_lat,
               the binding bound).  Fails when SIM resolves to a backend
               other than ``vector`` or ``ports`` disagrees with ``simple``
               at SP;
  8. analysis — after 4c, the analysis tier of the port, from this
               process (which holds the card's context): 8a ``lint`` on the
               paper's three listings and the traced stencils at the
               main-path sizes and ``machine validate`` on the bundled
               files (exit 0, no error, no ``L000``; the findings counted
               by severity); 8b ``python -m repro_torch analyze
               stencil_3d_long_range.c -m H100 -p ecm -p roofline -D M 130
               -D N 1015 --cores 132 --json`` in a child process, equal bit
               for bit to this process's ``analyze`` (the ``--cores`` keys
               too), then the same request through the result store
               (``--cache-dir``) cold and warm, each in a fresh process
               (seconds of the call and of the process), and its text
               report; 8c ``sweep stencil_3d7pt.c --range 64 1024 8 -D M
               512 --dense --workers 4`` through the store in this
               process: the spawned pool's points equal the sequential
               sweep's, and the warm run computes nothing (cold and warm
               host seconds), then in fresh processes as a user runs it
               (sequential, pooled cold and warm; the same gates); 8d ``tune stencil3d7pt`` (top 2 and the
               default, in this process) through the store twice on the
               card: the first measures on the CUDA kernel (its counter
               moves; the chosen candidate is held against the plain
               version), the second is one store hit with an equal report
               and no launch, and a ``--device cpu --no-measure`` request
               in the same directory is a miss.  ``--out`` keeps the
               seconds under ``predicted.analysis_tier``;
  5. tune    — ``tune flash_attention`` at granite-8b's attention (32
               heads, head_dim 128, bf16, causal, batch 1, seq 4096):
               predict every candidate, measure the top 4 and the default
               in child processes, derive calibration and merge it into
               the copy of the machine file under ``build/`` (the stencil
               factors of 4b stay); then one launch
               at the chosen blocks in this process, held against the
               plain version and timed beside the plain version, SDPA
               (the yardstick only) and the bound.  The chosen blocks
               must take the wgmma route, and its counter must move;
  6. f32     — ``tune flash_attention`` at the same attention in float32
               (top 4 and the default measured in child processes, no
               calibration written); the chosen blocks must take the
               bf16x3 route: one launch held against the plain version,
               timed with its split pass (the split also alone), beside
               the plain version, SDPA in f32, the three-pass bound and
               the FP32 floor; then the CUDA-core route at the same shape
               at ``SIMT_BLOCKS`` (128, 32), the fastest simt pair, and at
               (64, 32), the pair timed before, held and timed, with the
               share of the FP32 floor and the ratio to SDPA in f32;
  7. models  — gemma-7b's attention (16 heads of 256) and zamba2-7b's (32
               heads of 112, run at 128 with zero columns) at the same
               length, in bf16 and f32: one launch at ``default_config``,
               which must take the dtype's tensor-core route, held against
               the plain version and timed beside the CUDA-core kernel at
               the pair it took before (``force_simt=True``, held too),
               the plain version, SDPA (the yardstick only) and the bound
               at the real head dim (and at the padded one); then ``tune
               flash_attention`` at gemma-7b's attention in bf16 (top 4 and
               the default measured in child processes), whose choice
               must take the wgmma route.
  9. serve  — the LM stack (``repro_torch.models``, ``serve``):
               9a, each of the ten reduced configs in its own types on
               the card and twice on the CPU (its types, and float32 as
               the yardstick) from the same seeded parameters:
               ``forward``, then prefill and 4 decode steps; the card's
               logits must lie no further from the float32 run than 1.5x
               the CPU's own run plus 0.05, and every config with causal
               attention must reach the flash kernel.  9b, granite-8b at
               its published widths and full depth (tp=1, bf16, weights
               drawn on the card from a seed) behind ``BatchedServer``
               (batch 4): 8 requests of 512-1024 tokens, 32 new tokens
               each, ``max_len`` 1088; prefill ms per bucket and decode
               ms per step (CUDA events), tokens/s, peak memory, each
               beside its bound (16.1 GB of weights and the kv cache at
               3.35 TB/s; 15.7 GFLOP a token at 989 TFLOP/s); flash
               launches per route, at least 36 per prefill bucket on
               wgmma; ``torch.profiler`` device time by kernel and class
               (flash, GEMM, other) for one prefill and one decode step.
               9c, every flash call of 9a, of both buckets' prefills and
               of the cut serves below held against plain on its own
               operands (2e-2 times max(1, max |v|) in bf16) and each
               shape again on unit-normal operands (2e-2); the call of
               the longest bucket timed beside plain, SDPA, its own bound
               and the model's attention's (8 kv heads, the real rows);
               the greedy agreement with the teacher-forced forward at
               full depth printed; then the same widths cut to
               ``GREEDY_CUTS`` (1 layer in bf16, 2 in float32) served
               again, whose greedy tokens may disagree with the forward's
               argmax only where its top-two gap is within
               ``GREEDY_MARGIN``, and to the deeper ``GREEDY_PAST``,
               printed only;
  10. train — the training path (``repro_torch.{optim,train,data}``):
               10a, one ``make_train_step`` step of each of the ten
               reduced configs (4 sequences of 16 tokens in 2
               microbatches, remat on) on the card and on the CPU, in
               float32 and in the config's own types, from the same
               seeded parameters, state and batch; the card's float32
               step (flash on bf16x3) may lie no further than
               ``TRAIN_TOL`` from the CPU's (each metric relative to its
               value, each leaf of the first moment, which carries the
               gradient, relative to its largest entry), the own-type
               steps' distance from float32 is printed, every flash
               call under grad (forward and remat's re-forward) is held
               against plain on its own operands, and every backward of
               ``FlashAttentionFn`` (``flash_attention_backward``: the
               kernel in bf16, ``attention_backward`` in float32) against
               autograd through plain on its own operands (FA_TOL of each
               gradient's largest entry).  10b, granite-8b at its published widths (tp=1)
               cut to 8 layers, trained by ``Trainer`` with
               ``TrainConfig``'s defaults (bf16, remat, AdamW with fp32
               master, m and v) on ``SyntheticLM`` at 4096 tokens, batch
               4 in 4 microbatches: one warm-up step (its flash calls
               and backwards held as in 10a) and 4 timed (CUDA events);
               loss, grad norm, lr and the flash launches and backwards
               of each step (64 wgmma launches and 32 kernel backwards
               each, none plain, zero restarts), tokens/s, peak memory, the step's bound
               (flops at 989 TFLOP/s) and one AdamW pass's bytes at 3.35
               TB/s, and one more step under ``torch.profiler`` by class
               (GEMM, flash forward, attention backward, elementwise,
               optimizer); then the drop check (one layer, 256 tokens:
               each leaf's float32 gradient on the card within
               ``DROP_TOL`` of its largest entry from the CPU's float32
               gradient through autograd of plain, wq, wk and wv
               non-zero; the bf16 gradient within ``BF16_DROP_TOL`` of
               the card's float32 one) and the
               flash call at the training shape timed beside plain,
               SDPA and its bound, and the backward kernel beside
               ``attention_backward``, SDPA's forward plus backward and
               its bound;
  13. dist  — distribution (``repro_torch.{dist,launch.mesh,launch.cell}``,
               DTensor) after 10b's memory is freed: a process group of
               one rank on NCCL over a file store under ``build/``, a
               (1, 1) (data, model) mesh on the card.  13a,
               ``compressed_psum_tree`` on granite-8b's wq (4096 x 4096,
               float32): bit-exact to the local dequantised value, error
               feedback telescoping over 8 repeats, its ms beside NCCL's
               all_reduce of the same bytes alone; 13b, 10b's cell again
               with ``Trainer(rule=rule_for(cfg, train_4k), mesh=...)``
               (parameters, state and batches DTensors; the flash kernel
               on each rank's (batch, head) shard under ``local_map``):
               each step's loss and grad norm within ``SHARDED_TOL`` of
               10b's, 64 wgmma launches and 32 kernel backwards a step
               (none plain), the first
               step's flash calls and backwards held as in 10b, ms a step,
               tokens/s and peak memory beside 10b's, one step under
               ``torch.profiler`` (host ms, the card's busy share, the
               longest idle gaps), the loss's vocab-parallel bodies on
               one microbatch's float32 logits with the split forced
               onto `model` (a one-rank mesh dim, which the step itself
               runs unsharded) against ``torch.logsumexp`` and
               ``gather`` within ``VOCAB_TOL``, the flash call timed as
               the sharded path makes it (``attention._flash_shards`` on DTensor
               operands: ``local_map``, the layout copies, the kernel)
               beside the kernel alone; 13c, ``gpipe`` at one stage over
               4 microbatches of a granite-8b block at its published
               widths against the block on the whole batch
               (``GPIPE_TOL``), one flash launch a microbatch; 13d,
               ``ckpt.save`` from the mesh and ``restore(...,
               shardings=...)`` onto it for the reduced granite's
               parameters and int8 AdamW state, bit for bit;
     Launch counters are zeroed just before each main path (4, each
     family of 4b, each tune of 8d, 5, 6, each model and type of 7, each
     config of 9a, 9b's serving, each config of 10a, 10b's training, 13b's
     and 13c's) and must be positive just after it (in 6: bf16x3, its
     split, simt; in 8d's replay, zero);
  11. fleet — graph-level analysis (``repro_torch.fleet``), host only, no
               launch: 11a ``fleet --all -m IVY -m V5E`` (the port's
               copies of the JAX package's two machine files, by alias)
               into ``build/``, whose 20
               artifacts ``scripts/fleet_gate.py``'s ``compare`` (loaded
               by path; it imports only the standard library) holds
               against ``benchmarks/golden/fleet/``: 20 pairs, no
               failure, none missing; 11b ``python -m repro_torch fleet
               --all -m H100 --cache-dir C --json`` in a fresh process
               (its module run by ``runpy`` under a wrapper that counts
               the module walks and reads the service's counters): ten
               reports, each conserving and equal to this process's
               ``FleetAnalyzer().analyze(config, "H100")``, and
               granite-8b's rendered report; 11c the same command again:
               ten disk hits, nothing computed, no module walked, the
               same output, cold and warm host seconds; 11d ``analyze
               configs/hlo/granite-8b.hlo.gz -m H100 -p hlo-roofline
               --json``, whose terms must equal 11b's module roofline;
  14. graph  — graph-level analysis of the port's own programs
               (``repro_torch.core.graph_analysis``, ``launch.dryrun``,
               the ``graph`` frontend), after 11: the names it relies on
               checked in this torch first, the recorder on a new op of
               a fake (2, 2) mesh in a child (``META_PROBE``: the local
               shard's ops alone, DTensor's global-shape metadata run
               skipped), and the host microseconds
               to enqueue a flash call through the operator and through
               the wrapper at 9b's served shape; 14a the dry run of
               ``tests/test_dryrun.py``'s four cells (granite-8b
               ``train_4k``, deepseek-v3-671b ``decode_32k``, mamba2-2.7b
               ``long_500k``, whisper-small ``prefill_32k``) on
               ``pod16x16`` and ``pod2x16x16``, and of zamba2-7b,
               mamba2-2.7b, whisper-small and gemma-7b ``train_4k`` on
               ``pod16x16`` (``TRAIN_CELLS``), each cell in a child
               process with its own fake process group (this one holds
               13's NCCL group), all started at once under
               ``DRYRUN_TIMEOUT``: per cell and mesh the three terms on
               the H100 file, the dominant one, GiB a device, the
               collective kinds, the host seconds and the three ops that
               move the most bytes (``top_traffic``), each training cell
               beside the JAX package's own figure for it and failing
               the phase at that figure or ``CARD_GIB`` or more; 14b,
               while they run, one untimed step of 10b's cell and one prefill of
               9b's first bucket recorded on the card (every flash call
               one ``repro_torch::flash_attention`` operator: 64 in the
               step, 36 in the prefill), priced on the H100 file: the
               predicted ms (each op's roofline summed, and serial)
               beside 10b's and 9b's measured ms, the five costliest
               (operator, shape) groups, and the step's predicted ms by
               10b's profile classes beside the profile's; 14c ``fleet
               --config graph:<arch>`` for the ten reduced configs in a
               fresh process, each report conserving, beside the bundled
               dumps' reports (flops over JAX's, collective kinds);
  15. examples — the port's five examples (``examples/torch_*.py``), each
               a child process from the checkout's root, as a user runs
               them: ``torch_quickstart`` (the 7-point kernel),
               ``torch_stencil_modeling`` (the long-range kernel; the
               §3 case study from the C file and the traced point
               function), ``torch_serve_batched`` and ``torch_train_100m``
               (flash attention on the wgmma route) on the card, and
               ``torch_multipod_pipeline --device cpu --ranks 8`` on gloo
               ranks (one card here); each must exit 0 (the stencil
               examples hold their kernel against the plain version at
               the reference tolerances, serving and training the
               model's flash call against the plain attention at
               bfloat16's 2e-2, the pipeline against the sequential
               model) and print its route line; its wall seconds
               printed;
  12. a JSON line naming each ported kernel (flash attention once per
     route, once per route, model and type of 7, once on 9b's serving
     path, once on 10b's training path and once on 13b's sharded one),
     then the card's line, then
     ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX or of the JAX package ``repro``; it needs the
repository's ``src/repro_torch`` beside it and a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
# ragged shapes and the ring's edges: N not a multiple of 4, N below one
# tile, M <= 2r, M below the ring's stages
RAGGED = [(12, 37, 37), (20, 45, 45), (3, 9, 9), (12, 5, 5), (2, 33, 33),
          (8, 64, 64), (4, 40, 40)]
MAIN = {"stencil3d7pt": (512, 512, 512), "longrange3d": (130, 1015, 1015)}
# tolerances of the reference's own kernel tests (tests/test_kernels.py):
# the kernel contracts a*b+c into FMAs and the plain version does not
TOL = {"stencil3d7pt": dict(rtol=2e-5, atol=1e-6),
       "longrange3d": dict(rtol=2e-4, atol=1e-5)}
REPLACES = {"stencil3d7pt": "src/repro/kernels/stencil3d7pt.py:77",
            "longrange3d": "src/repro/kernels/longrange3d.py:91",
            "flash_attention": "src/repro/kernels/flash_attention.py:150"}
# the kernels line's entry per flash route
FA_ENTRY = {"wgmma": "flash_attention", "simt": "flash_attention_simt",
            "bf16x3": "flash_attention_bf16x3"}
# the tensor-core route of each type
TC_ROUTE = {torch.float32: "bf16x3", torch.bfloat16: "wgmma"}
# flash attention: the reference's tolerances (tests/test_kernels.py)
FA_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
# granite-8b's attention (src/repro/configs/granite_8b.py: 32 heads of
# 128) at the train_4k length, bf16, causal, batch 1
GRANITE = {"batch": 1, "heads": 32, "seq_q": 4096, "seq_kv": 4096,
           "head_dim": 128, "causal": True, "dtype": "bfloat16"}
GRANITE_F32 = {**GRANITE, "dtype": "float32"}
# the CUDA-core route's pair at the granite shape in f32: off the bf16x3
# set (block_kv 32), the fastest simt pair measured at this shape (the
# tiled kernel at (128, 32)); SIMT_BLOCKS_BEFORE, the pair phase 6 timed
# before the tiled kernel, is timed beside it
SIMT_BLOCKS = (128, 32)
SIMT_BLOCKS_BEFORE = (64, 32)
# phase 3's CUDA-core cases, forced onto simt in both types, causal and
# full, q_offset > 0: (head_dim, blocks, seq_q, seq_kv) — head dims off
# every tensor-core rule (4, 100, 136, 264), blocks of 4, 48 and 116, the
# tiled kernel's triples at their own and padded head dims (the
# tests/test_torch_port.py SIMT_CASES)
SIMT_CASES = [(4, (4, 4), 64, 96), (100, (64, 32), 128, 256),
              (136, (64, 32), 128, 192), (264, (64, 32), 128, 192),
              (128, (48, 48), 96, 192), (100, (116, 4), 116, 232),
              (128, (128, 32), 128, 256), (112, (64, 64), 128, 256),
              (256, (64, 32), 64, 128), (128, (64, 32), 128, 256)]
# gemma-7b (src/repro/configs/gemma_7b.py: 16 heads of 256, kv 16) and
# zamba2-7b (src/repro/configs/zamba2_7b.py: 32 heads of 112, kv 32) at
# the same length; the tensor-core routes pad 112 to 128
REAL_MODELS = {"gemma-7b": {**GRANITE, "heads": 16, "head_dim": 256},
               "zamba2-7b": {**GRANITE, "heads": 32, "head_dim": 112}}
# the pair each took on the CUDA cores before their head dims had a
# tensor-core route: default_config's (64, 64) row, its block_kv halved
# at 256 until the fp32-staged tiles fit a CTA
SIMT_BEFORE = {"gemma-7b": (64, 32), "zamba2-7b": (64, 64)}
# the stencil tunes measure the top 5 by prediction and the default: at
# least the top 4 and the default when the default is among the top 4
STENCIL_TOP_K = 5
# phase 4c: the warm-up rows that cover each stencil's 3D layer condition
# (the planes a row's reads reach back), the host seconds the phase may
# spend, and the rows of the probe that sizes a warm-up cut to fit
SIM_DEEP_ROWS = {"stencil3d7pt": lambda n: 2 * n + 2,
                 "longrange3d": lambda n: 8 * n + 2}
SIM_BUDGET_S = 30.0
SIM_MARGIN_S = 6.0
SIM_PROBE_ROWS = 256
TC_KERNEL = re.compile(r"_ZN\w*?(flash_attention_(?:wgmma|bf16x3)_kernel)"
                       r"ILi(\d+)ELi(\d+)ELi(\d+)E\w*")
SIMT_KERNEL = re.compile(r"_ZN\w*?(flash_attention_simt_kernel|"
                         r"flash_attention_kernel)I(f|13__nv_bfloat16)"
                         r"(?:NS_4TileILi(\d+)ELi(\d+)ELi(\d+)E\w*|E\w*)")
BWD_KERNEL = re.compile(r"_ZN\w*?"
                        r"(flash_attention_bwd_(?:rows|fused|dq)_kernel)"
                        r"ILi(\d+)E\w*")
# the backward's launches by the names the profiler gives them
BWD_PASS = re.compile(r"flash_attention_bwd_(rows|fused|dq)_kernel")
STENCIL_KERNEL = re.compile(r"_ZN\w*?(stencil3d7pt|longrange3d)_kernel"
                            r"ILi(\d+)E\w*")
# phase 8: lint's sources at the main-path sizes; analyze at the paper's
# section 3 size on all SMs (in a child process and through the store); the
# 7-point sweep over the tune space's edges at the main path's M, sharded
# over spawned workers; the stencil tune measuring its top 2 and default
LINT_SOURCES = {"stencil_2d5pt.c": {"M": 130, "N": 1015},
                "stencil_3d7pt.c": {"M": 512, "N": 512},
                "stencil_3d_long_range.c": {"M": 130, "N": 1015},
                "trace:stencil3d7pt": {"M": 512, "N": 512},
                "trace:longrange3d": {"M": 130, "N": 1015}}
ANALYZE = {"source": "stencil_3d_long_range.c", "models": ["ecm", "roofline"],
           "constants": {"M": 130, "N": 1015}, "cores": 132}
ANALYZE_ARGV = ["analyze", ANALYZE["source"], "-m", "H100", "-p", "ecm",
                "-p", "roofline", "-D", "M", "130", "-D", "N", "1015",
                "--cores", "132"]
SWEEP = {"source": "stencil_3d7pt.c", "range": (64, 1024, 8),
         "constants": {"M": 512}, "workers": 4}
SWEEP_ARGV = ["sweep", SWEEP["source"], "-m", "H100", "--param", "N",
              "--range", "64", "1024", "8", "-D", "M", "512", "--dense",
              "--workers", "4"]
TUNE_TOP_K = 2
# phase 9: the reduced configs on the card (batch, tokens: prefill and
# forward within one chunk of the reduced Mamba-2 scan, 16; decode steps;
# cache length), and 9a's rule — the card's logits no further from the
# float32 CPU run than BF16_FACTOR times the CPU's own run in the
# config's types, plus BF16_SLACK (tests/test_torch_lm.py holds the port
# to JAX by the same rule)
REDUCED_SHAPE = (2, 16)
REDUCED_STEPS = 4
REDUCED_MAX_LEN = 64
BF16_FACTOR, BF16_SLACK = 1.5, 0.05
# granite-8b served at full width: 8 requests of 512-1024 tokens, 32 new
# tokens each, batch 4; max_len at least 1024 + 32
SERVE_ARCH = "granite-8b"
SERVE = {"requests": 8, "prompt": (512, 1024), "max_new": 32,
         "batch_size": 4, "max_len": 1088}
# 9c: a greedy token may differ from the teacher-forced forward's argmax
# only where the forward's top-two gap is within GREEDY_MARGIN, two bf16
# steps of a logit of magnitude 4-8 (2^-5 each).  This init (the fan-in of
# wq is its heads axis, so scores reach the hundreds) is chaotic with
# depth: a rounding that moves a score moves which key the softmax picks,
# and each layer multiplies the change.  At 36 layers the served logits
# lie as far from the forward's as logits reach, so there the agreement
# is printed, not gated.  The gate serves the same widths cut to the
# GREEDY_CUTS depths, at which the serving path's rounding leaves the
# greedy tokens alone: one layer in bf16, and two in float32, where the
# flash kernel's bf16x3 scores (about 2^-16 relative) are the rounding of
# note, so that the stacked caches of two layers are checked too.  The
# depths of GREEDY_PAST, a layer deeper, are served and printed to show
# where the rounding starts to move tokens.  (Deeper still, the float32
# scores grow sharp enough that the bf16x3 kernel's own-operand error
# nears checked_flash's tolerance.)
GREEDY_CUTS = (("bfloat16", 1), ("float32", 2))
GREEDY_PAST = (("bfloat16", 2), ("float32", 3))
GREEDY_MARGIN = 2 ** -4
PROFILE_ROWS = 12
# phase 10a: one train step of each reduced config (4 sequences of 16
# tokens in 2 microbatches, lr 1e-3, remat on), and its rule: the card's
# step in float32 (flash on bf16x3 under its Function) no further than
# TRAIN_TOL from the CPU's float32 step, in relative terms (each metric
# against its value, each leaf of the first moment, which carries the
# gradient, against its largest entry).  A dropped gradient reads 1.0.
# Measured on the card: 2.6e-6 (mamba2) to 5.5e-3 (llama4's MoE).  The
# steps in the configs' own types are printed, not gated: bf16 alone
# moves a leaf by up to 2.8 of its largest entry at this init
TRAIN_REDUCED = {"batch": 4, "seq": 16, "microbatches": 2, "lr": 1e-3}
TRAIN_TOL = 2e-2
# phase 10b: granite-8b at its published widths, depth cut from 36 to 8
# layers (8 layers' 2.0 B parameters at 16 B each, 32.2 GB, fit one 80 GB
# card; 36 layers' 133.7 GB do not, sharded or not, on one card), at SHAPES['train_4k']'s 4096 tokens with its global
# batch of 256 cut to 4, in 4 microbatches of 1: one warm-up step, then 4
# timed
TRAIN_ARCH = "granite-8b"
TRAIN = {"layers": 8, "seq": 4096, "batch": 4, "microbatches": 4,
         "warmup": 1, "timed": 4}
# the check that would catch a dropped gradient: one layer at the same
# widths and 256 tokens, the card's float32 gradient of each leaf (the
# bf16x3 flash kernel under its Function, whose backward is
# attention_backward) no further than DROP_TOL of the leaf's largest
# entry from the CPU's float32 gradient through autograd of plain (which
# shares no code with the Function), and wq, wk and wv's gradients
# non-zero.  A dropped gradient reads 1.0; measured on the card, the
# worst leaf reads 2.2e-4.  The card's bf16 gradient (the wgmma route)
# is held against its float32 one only within BF16_DROP_TOL, which a
# leaf dropped whole exceeds: bf16 alone moves wq, wk and the attention
# norm's gain by 0.56-0.67 at this init (measured on the card): q and k
# entries of std 11 and 23 round by about 0.5 a score, which scales the
# non-winning keys' softmax weights by e^±0.5, and where the softmax is
# nearly one-hot their gradient, dS = P ⊙ (dP - rowsum(P ⊙ dP)), is made
# of those weights alone
DROP = {"layers": 1, "seq": 256, "batch": 1}
# phase 13: the compressed all-reduce on granite-8b's wq (4096 x 4096,
# float32) and its error feedback over 8 repeats; 13b's steps against
# 10b's, each loss and grad norm within SHARDED_TOL of 10b's, relative (at
# one rank the sharded step runs the same local operations: both read 0.0
# apart; the bound leaves room for a reduction's order only); gpipe at one
# stage over 4 microbatches of 1024 tokens, each element of its output
# within GPIPE_TOL of the block's on the whole batch, relative: one bf16
# ulp, where cuBLAS picks another kernel for another row count (read 0.0)
COMPRESS = {"shape": (4096, 4096), "repeats": 8}
SHARDED_TOL = 1e-5
# 13b's vocab-shard check: the loss's vocab-parallel body
# (``train.step._vocab_lse_and_label``) on one
# microbatch's float32 logits, the split forced onto the mesh's `model`
# dim, against ``torch.logsumexp`` and ``gather`` on the whole tensor:
# the values and the gradient each within VOCAB_TOL of the largest
VOCAB_TOL = 1e-5
GPIPE = {"batch": 4, "seq": 1024, "microbatches": 4}
GPIPE_TOL = 2 ** -7
DROP_TOL = 2e-2
BF16_DROP_TOL = 0.9
# heads per slice of the backward check's autograd through plain
BACKWARD_HEADS = 8
# the backward kernel against attention_backward in the flash phase:
# (name, (b, h, sq, d), skv, q_offset, rows of zero dO at the end of q):
# granite-8b's training call, zamba2-7b's head dim 112 (padded to 128),
# phi-3's 96, 10a's reduced shape (head dim 32, 16 tokens padded to 64
# rows), a causal call with sq < skv and q_offset > 0, the zero dO
# that attention.flash's q padding carries, and an odd number of 64-row kv
# blocks (17: the serving cache's 1088 rows), whose last fused-pass item
# has one consumer idle
BACKWARD_CASES = (
    ("granite-8b", (1, 32, 4096, 128), 4096, 0, 0),
    ("zamba2-7b d112", (1, 32, 1024, 112), 1024, 0, 0),
    ("phi3 d96", (1, 32, 1024, 96), 1024, 0, 0),
    ("10a d32", (4, 4, 64, 32), 64, 0, 0),
    ("sq < skv", (2, 8, 256, 128), 1024, 700, 0),
    ("zero dO rows", (2, 8, 512, 64), 512, 0, 37),
    ("odd kv blocks", (2, 16, 1088, 128), 1088, 0, 0))
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers")


# the SSD scan phase (3b): mamba2-2.7b's training shape (b, L, h, P, N,
# Q) in bf16, and the largest |kernel - plain| allowed per output as a
# share of the plain value's largest entry: y and the dt and l_t
# gradients are fp32 on both sides but S = C.B^T is rounded to bf16 after
# fp32 sums in other orders, so an entry near a rounding boundary takes
# the other neighbour, one bf16 ulp away (300-336 of the 4.2 M causal
# entries at this shape), and moves its terms by that much: 1.8e-4 to
# 2.3e-3 of the largest entry over five draws of the operands, as the few
# hundred such entries fall against dt and x.  The phase's "exact S"
# witness draws B and C from {-1, 0, 1}, so that S is exact on both sides:
# there y, dt and l_t agree within 1.1e-6.  dx, dB and dC are stored in
# bf16 (one ulp is up to 2^-7 of the largest entry) after the plain
# version's autograd rounded its parts to bf16 on the way
# (tests/test_torch_ssd.py holds the arithmetic itself in float32)
SSD_CELL = (8, 4096, 80, 64, 128, 256)
# the scan's other runners, timed beside the cell: zamba2-7b's state
# (112 heads, N 64) at the cell's rows, and mamba2-2.7b's heads split
# over four ranks (20 a rank), as the head-sharded path hands them over
SSD_OTHER = {"zamba2-7b": (8, 4096, 112, 64, 64, 256),
             "mamba2-2.7b, 20 heads a rank": (8, 4096, 20, 64, 128, 256)}
# a serving prefill of the long_500k cell's 524,288 tokens, one row
SSD_PREFILL = (1, 524_288, 80, 64, 128, 256)
SSD_TOL = {"y": 4e-3, "final": 1e-5, "xh": 3e-2, "B": 3e-2, "C": 3e-2,
           "dt": 4e-3, "l_t": 4e-3, "Dp": 1e-4, "state": 1e-5}


class SmokeError(Exception):
    """A failed phase.  Not a ``RuntimeError``: the trainer of phase 10
    would take one raised inside its step for a node failure and replay
    the step."""


_PHASE = {"name": "", "t0": 0.0, "start": time.perf_counter()}


def phase(name: str) -> None:
    """Print the last phase's seconds, then the next phase's heading."""
    now = time.perf_counter()
    if _PHASE["name"]:
        print(f"  [{_PHASE['name']}: {now - _PHASE['t0']:.1f} s]")
    _PHASE.update(name=name, t0=now)
    print(f"\n=== {name} ===", flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def compare(name: str, got, want, halo: int) -> tuple[float, float]:
    """Max abs and max rel error of ``got`` against ``want`` (rel over
    ``max(|want|, atol)``), within tolerance, and a bit-exact boundary of
    width ``halo``; raises SmokeError otherwise."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise SmokeError(f"{name}: shape {tuple(got.shape)} or non-finite "
                         "values")
    err = (got - want).abs()
    bad = err > TOL[name]["atol"] + TOL[name]["rtol"] * want.abs()
    if bad.any():
        raise SmokeError(f"{name} {tuple(got.shape)}: {int(bad.sum())} "
                         f"values outside {TOL[name]}, max abs err "
                         f"{err.max().item():.3e}")
    inner = torch.zeros_like(got, dtype=torch.bool)
    M, N, _ = got.shape
    if M > 2 * halo and N > 2 * halo:
        inner[halo:-halo, halo:-halo, halo:-halo] = True
    if not torch.equal(got[~inner], want[~inner]):
        raise SmokeError(f"{name} {tuple(got.shape)}: boundary not a "
                         "bit-exact copy")
    rel = err / want.abs().clamp_min(TOL[name]["atol"])
    return err.max().item(), rel.max().item()


def check_kernel(name: str, shape, fam, stencil, ops) -> float:
    """The kernel (through its ops wrapper) against its plain version on
    the same inputs on the card; returns the max abs error."""
    args = stencil.make_inputs(name, shape, "cuda", SEED)
    got = fam.op(*args)
    want = fam.module.plain(*args)
    torch.cuda.synchronize()
    err, rel = compare(name, got, want, fam.module.RADIUS)
    plan = ops.plan(fam.module, args[0])
    print(f"  {name:13s} {str(shape):17s} plan {plan.launch} max abs err "
          f"{err:.3e}  max rel err {rel:.3e}  ok")
    return err


def conv3d_yardstick(a, coeffs):
    """One ``torch.nn.functional.conv3d`` computing the 7-point interior
    (timed only, as the library's figure; the port never calls it)."""
    cW, cE, cN, cS, cF, cB, s = coeffs
    w = torch.zeros(1, 1, 3, 3, 3, device=a.device, dtype=a.dtype)
    w[0, 0, 1, 1, 0], w[0, 0, 1, 1, 2] = cW, cE
    w[0, 0, 1, 0, 1], w[0, 0, 1, 2, 1] = cN, cS
    w[0, 0, 0, 1, 1], w[0, 0, 2, 1, 1] = cF, cB
    w[0, 0, 1, 1, 1] = s
    x = a.view(1, 1, *a.shape)
    return lambda: torch.nn.functional.conv3d(x, w)


def main_path(name: str, fam, stencil, measure) -> dict:
    shape = MAIN[name]
    pred = stencil.predict_seconds(name, shape, "H100")
    print(f"  {name} {shape} fp32, predicted on the H100 machine file at "
          f"{pred.cores} cores:")
    print(f"    ECM {pred.ecm.notation()}  overlapped "
          f"{[(n, round(c, 3)) for n, c in pred.ecm.overlapped]}")
    print(f"    ECM {pred.ecm_s * 1e3:.4f} ms   Roofline "
          f"{pred.roofline_s * 1e3:.4f} ms (bottleneck "
          f"{pred.roofline.bottleneck})")
    args = stencil.make_inputs(name, shape, "cuda", SEED)
    out = fam.op(*args)                      # the run through ops
    t_kernel = measure.time_cuda(lambda: fam.op(*args))
    torch.cuda.synchronize()
    if out.shape != shape or not torch.isfinite(out).all():
        raise SmokeError(f"{name}: main-path output not finite {shape}")
    return {"pred": pred, "args": args, "out": out, "t_kernel": t_kernel}


def report(name: str, run: dict, stencil, measure, h100, card: str, ops,
           sweep) -> dict:
    """Plain-version, ``copy_`` and library timings, the bound, the launch
    plan, and the kernels-line entry for one main-path run (launches are
    filled in by the caller)."""
    fam, args, pred = stencil.family(name), run["args"], run["pred"]
    plan = ops.plan(fam.module, args[0])
    err, rel = compare(name, run["out"], fam.module.plain(*args),
                       fam.module.RADIUS)
    t_plain = measure.time_cuda(lambda: fam.module.plain(*args), iters=3)
    lib_ms = None
    if name == "stencil3d7pt":
        conv = conv3d_yardstick(args[0], args[1])
        ref = conv()
        lib_err = (ref[0, 0] - run["out"][1:-1, 1:-1, 1:-1]).abs().max().item()
        if lib_err > 1e-4:
            raise SmokeError(f"conv3d yardstick disagrees by {lib_err:.3e}")
        lib_ms = measure.time_cuda(conv).wall_s * 1e3
    bound = stencil.bound_seconds(name, args, h100)
    ms = run["t_kernel"].wall_s * 1e3
    bound_ms = bound.seconds * 1e3
    copy_ms = sweep.copy_yardstick(bound.bytes).wall_s * 1e3
    print(f"  {name} {MAIN[name]} on {card}:")
    print(f"    plan     tile ({plan.bj}, {plan.bi}), {plan.c} points per "
          f"thread, {plan.stages} stages ({plan.ahead} planes in flight), "
          f"chunks of {plan.chunk} planes, {plan.ctas} CTAs of "
          f"{plan.threads} threads, {plan.smem_bytes} B shared, "
          f"{plan.ctas_per_sm} CTA/SM, {plan.in_flight_per_sm} B in flight "
          f"per SM, {plan.words_per_point:.3f} words fetched per point")
    print(f"    kernel   {ms:.4f} ms  ({bound.bytes / (ms / 1e3) / 1e12:.3f}"
          f" TB/s effective, {bound_ms / ms:.1%} of the bound)")
    print(f"    copy_    {copy_ms:.4f} ms for the same bytes "
          f"({bound_ms / copy_ms:.1%} of the bound)")
    print(f"    bound    {bound_ms:.4f} ms by {bound.by}  (bytes: "
          f"{bound.bytes / 1e9:.3f} GB at {h100.hbm_bandwidth / 1e12:.2f} "
          f"TB/s, {bound.bytes_s * 1e3:.4f} ms; ops at "
          f"{h100.peak_flops['FP32'] / 1e12:.0f} TFLOP/s fp32, "
          f"{bound.ops_s * 1e3:.4f} ms)")
    print(f"    plain    {t_plain.wall_s * 1e3:.4f} ms")
    print(f"    library  " + (f"{lib_ms:.4f} ms (conv3d, cudnn tf32 off)"
                               if lib_ms is not None else "none"))
    print(f"    predicted ECM {pred.ecm_s * 1e3:.4f} ms "
          f"(measured/predicted {ms / (pred.ecm_s * 1e3):.3f}), Roofline "
          f"{pred.roofline_s * 1e3:.4f} ms "
          f"(measured/predicted {ms / (pred.roofline_s * 1e3):.3f})")
    print(f"    main-path max abs err vs plain {err:.3e}, max rel err "
          f"{rel:.3e}")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": err, "ms": ms,
            "plain_ms": t_plain.wall_s * 1e3, "bound_ms": bound_ms,
            "bound_by": bound.by,
            "library_ms": lib_ms, "copy_ms": copy_ms,
            "plan": {"tile": [plan.bj, plan.bi], "c": plan.c,
                     "stages": plan.stages, "chunk": plan.chunk,
                     "ctas": plan.ctas, "ctas_per_sm": plan.ctas_per_sm,
                     "in_flight_per_sm": plan.in_flight_per_sm}}


def fa_compare(what: str, got, want, dtype) -> float:
    """Max abs error of a flash result against the plain version, within
    the reference tolerance ``|got - want| <= tol + tol * |want|``."""
    tol = FA_TOL[dtype]
    if got.shape != want.shape or got.dtype != dtype \
            or not torch.isfinite(got.float()).all():
        raise SmokeError(f"flash_attention {what}: shape, dtype or "
                         "non-finite values")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    if bad.any():
        raise SmokeError(f"flash_attention {what}: {int(bad.sum())} values "
                         f"outside {tol}, max abs err {err.max().item():.3e}")
    return err.max().item()


def qkv(shape_q, skv: int, dtype, seed: int):
    """q, k, v normal from ``seed``, made on the card in fp32, rounded."""
    b, h, _, d = shape_q
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in (shape_q, (b, h, skv, d), (b, h, skv, d))]


def routed(fa, call):
    """``call()`` and the one flash route whose launch counter it moved."""
    n0 = dict(fa.flash_attention.launches_by_route)
    out = call()
    moved = [r for r, n in fa.flash_attention.launches_by_route.items()
             if n != n0[r]]
    if len(moved) != 1:
        raise SmokeError(f"flash_attention launched on {moved or 'no route'}"
                         ", not on one")
    return out, moved[0]


def check_split(fa) -> float:
    """The split kernel bit-exact against ``plain_split`` on the card, at
    the decode shape's q against 4096 keys, values spread over 40
    binades; returns the max abs difference of its halves (0)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def draw(shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        e = torch.randint(-20, 20, shape, generator=gen, device="cuda")
        return x * torch.exp2(e.float())
    xs = [draw((1, 32, n, 128)) for n in (128, 4096, 4096)]
    n0 = fa.split_bf16x3.launches
    halves = fa.split_bf16x3(*xs)
    torch.cuda.synchronize()
    if fa.split_bf16x3.launches != n0 + 1:
        raise SmokeError("split_bf16x3 did not count one launch")
    err = 0.0
    for name, (hi, lo), x in zip("qkv", halves, xs):
        want = fa.plain_split(x)
        for got, w, part in ((hi, want[0], "hi"), (lo, want[1], "lo")):
            if not torch.equal(got.view(torch.int16), w.view(torch.int16)):
                raise SmokeError(f"split {name} {part} differs from "
                                 "plain_split")
            err = max(err, (got.float() - w.float()).abs().max().item())
    print(f"  bf16x3 split of q {tuple(xs[0].shape)}, k and v "
          f"{tuple(xs[1].shape)}: hi and lo bit-exact against plain_split")
    return err


def check_flash(fa, ops, space) -> dict[tuple[str, str], float]:
    """Every flash route against the plain version on the card; returns
    the max abs error per (route, dtype)."""
    worst: dict[tuple[str, str], float] = {}

    def case(what: str, call, want, dtype, expect: str) -> str:
        got, route = routed(fa, call)
        if route != expect:
            raise SmokeError(f"flash {what} ran on {route}, not {expect}")
        err = fa_compare(what, got, want, dtype)
        key = (route, str(dtype)[6:])
        worst[key] = max(worst.get(key, 0.0), err)
        return f"{route:6s} max abs err {err:.3e}  ok"

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        expect = TC_ROUTE[dtype]
        for d in (32, 40, 64, 96, 112, 128, 136, 256):
            for causal in (True, False):
                q, k, v = qkv((2, 4, 256, d), 512, dtype, seed=d)
                what = f"{name} d={d} causal={causal}"
                res = case(what, lambda: ops.flash_attention(
                    q, k, v, causal=causal), fa.plain(q, k, v, causal=causal),
                    dtype, expect)
                print(f"  flash (2, 4, 256, {d}) kv 512 {what:28s} {res}")
        q, k, v = qkv((1, 32, 128, 128), 4096, dtype, seed=1)
        res = case(f"decode {name}", lambda: ops.flash_attention(q, k, v),
                   fa.plain(q, k, v), dtype, expect)
        print(f"  flash decode (1, 32, 128, 128) kv 4096 (q_offset 3968) "
              f"{name}: {res}")
        q, k, v = qkv((2, 4, 96, 64), 256, dtype, seed=3)
        want = fa.plain(q, k, v)
        for bq in (16, 32):
            res = case(f"padded block_q={bq} {name}", lambda: fa.flash_attention(
                q, k, v, block_q=bq, block_kv=64), want, dtype, expect)
            print(f"  flash (2, 4, 96, 64) kv 256 {name} causal, blocks "
                  f"({bq}, 64) in a 64-row tile: {res}")
        # off every tensor-core set: the CUDA-core route
        q, k, v = qkv((2, 4, 256, 128), 512, dtype, seed=4)
        res = case(f"{name} blocks {SIMT_BLOCKS}", lambda: fa.flash_attention(
            q, k, v, block_q=SIMT_BLOCKS[0], block_kv=SIMT_BLOCKS[1]),
            fa.plain(q, k, v), dtype, "simt")
        print(f"  flash (2, 4, 256, 128) kv 512 {name} blocks {SIMT_BLOCKS}: "
              f"{res}")
        # a head dim off tc_head_dim (not a multiple of 8)
        q, k, v = qkv((2, 4, 256, 100), 512, dtype, seed=5)
        res = case(f"{name} d=100", lambda: ops.flash_attention(q, k, v),
                   fa.plain(q, k, v), dtype, "simt")
        print(f"  flash (2, 4, 256, 100) kv 512 {name} through ops: {res}")
        # the CUDA-core kernels, tiled and general, forced onto simt
        for d, (bq, bkv), sq, skv in SIMT_CASES:
            q, k, v = qkv((1, 3, sq, d), skv, dtype, seed=d + bq)
            kern = ("tiled" if (bq, bkv, fa.simt_head_dim(bq, bkv, d))
                    in fa.SIMT_TILED_SET else "general")
            for causal in (True, False):
                for off in (skv - sq, (skv - sq) // 2):
                    what = (f"{name} simt {kern} d={d} ({bq}, {bkv}) "
                            f"causal={causal} q_offset={off}")
                    res = case(what, lambda: fa.flash_attention(
                        q, k, v, causal=causal, block_q=bq, block_kv=bkv,
                        q_offset=off, force_simt=True), fa.plain(
                        q, k, v, causal=causal, q_offset=off), dtype, "simt")
                    print(f"  flash (1, 3, {sq}, {d}) kv {skv} {what}: "
                          f"{res}")
    for dtype in ("float32", "bfloat16"):
        sp = space.resolve_space("flash_attention", "H100", batch=1,
                                 heads=4, seq_q=256, seq_kv=256,
                                 head_dim=128, causal=True, dtype=dtype)
        cands = sp.candidates()
        q, k, v = sp.inputs("cuda", seed=2)
        want = fa.plain(q, k, v)
        counts = dict.fromkeys(fa.SOURCES, 0)
        for c, pred in zip(cands, sp.predict(cands)):
            if not pred.feasible:
                continue
            bq, bkv = c.config["block_q"], c.config["block_kv"]
            case(f"candidate {bq}x{bkv} {dtype}", lambda: fa.flash_attention(
                q, k, v, block_q=bq, block_kv=bkv), want, q.dtype,
                sp.route(c))
            counts[sp.route(c)] += 1
        torch.cuda.synchronize()
        print(f"  flash: all {sum(counts.values())} feasible candidates of "
              f"{len(cands)} in the seq-256 {dtype} space launch and match, "
              f"by route {counts}")
    print("  worst max abs err per (route, dtype): " + ", ".join(
        f"{r} {t} {e:.3e}" for (r, t), e in sorted(worst.items())))
    return worst


def backward_errors(got, want) -> list[float]:
    """Each of dQ, dK and dV's max abs error over its reference's largest
    entry; raises past FA_TOL[bf16] or on a non-finite value."""
    tol = FA_TOL[torch.bfloat16]
    rel = []
    for name, g, w in zip("qkv", got, want):
        top = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        rel.append(err / max(top, 1e-30))
        if g.dtype != w.dtype or not torch.isfinite(g.float()).all() \
                or not err <= tol * top:
            raise SmokeError(f"flash backward d{name}: {err:.3e} from "
                             f"attention_backward, over {tol} x {top:.3e}, "
                             "or not finite")
    return rel


def check_backward(fa, space, measure, h100) -> dict:
    """The backward kernel against ``attention_backward`` on the card at
    BACKWARD_CASES (unit-normal bf16 operands from SEED), each run twice
    (the two results bitwise equal: dQ's shares summed in a fixed order)
    and counted as one kernel call each; then its time at granite-8b's
    shape beside ``attention_backward``, SDPA's forward plus backward and
    its backward alone (the yardsticks), ``attention_backward_bound`` and
    each pass's ms.  Returns the worst error over its
    tolerance's reference, the max abs error and the times."""
    worst = abs_err = 0.0
    for i, (name, shape, skv, q_offset, zero) in enumerate(BACKWARD_CASES):
        q, k, v = qkv(shape, skv, torch.bfloat16, SEED + i)
        do = qkv(shape, skv, torch.bfloat16, SEED + 100 + i)[0]
        if zero:
            do[:, :, -zero:] = 0
        n0 = fa.flash_attention.backward_calls_by_route["kernel"]
        runs = [fa.flash_attention_backward(q, k, v, do, causal=True,
                                            q_offset=q_offset)
                for _ in range(2)]
        torch.cuda.synchronize()
        if fa.flash_attention.backward_calls_by_route["kernel"] != n0 + 2:
            raise SmokeError(f"backward {name}: not on the kernel route")
        same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in zip(*runs))
        if not same:
            raise SmokeError(f"backward {name}: two runs differ in bits")
        want = fa.attention_backward(q, k, v, do, causal=True,
                                     q_offset=q_offset)
        rel = backward_errors(runs[0], want)
        worst = max(worst, max(rel))
        abs_err = max(abs_err, *((g.float() - w.float()).abs().max().item()
                                 for g, w in zip(runs[0], want)))
        tail = ""
        if zero:
            keys = q_offset + shape[2] - zero
            quiet = all(torch.count_nonzero(t) == 0 for t in (
                runs[0][0][:, :, -zero:], runs[0][1][:, :, keys:],
                runs[0][2][:, :, keys:]))
            if not quiet:
                raise SmokeError(f"backward {name}: gradient where only the "
                                 "zero dO rows reach")
            tail = ("; dQ of those rows and dK, dV of the keys only they "
                    "see zero")
        print(f"  backward {name:15s} q {shape} kv {skv} q_offset "
              f"{q_offset}: d(q, k, v) {', '.join(f'{r:.2e}' for r in rel)} "
              f"of the largest entry (tolerance {FA_TOL[torch.bfloat16]}), "
              f"two runs bitwise equal{tail}")
        del q, k, v, do, runs, want
    shape = (1, GRANITE["heads"], GRANITE["seq_q"], GRANITE["head_dim"])
    q, k, v = qkv(shape, GRANITE["seq_kv"], torch.bfloat16, SEED)
    do = qkv(shape, GRANITE["seq_kv"], torch.bfloat16, SEED + 1)[0]
    t = backward_times(fa, space, measure, h100, q, k, v, do)
    t["passes_ms"] = backward_passes_ms(fa, q, k, v, do)
    print(f"  backward at {shape} bf16 causal: kernel {t['ms']:.4f} ms "
          f"({t['bound_ms'] / t['ms']:.1%} of its bound {t['bound_ms']:.4f}"
          f" ms by {t['bound_by']}), attention_backward {t['plain_ms']:.4f}"
          f" ms, SDPA forward + backward {t['library_ms']:.4f} ms, SDPA "
          f"backward alone {t['library_backward_ms']:.4f} ms (yardsticks "
          f"only; the kernel {t['ms'] / t['library_backward_ms']:.3f}x "
          f"SDPA's backward)")
    print("  backward passes at the same shape (torch.profiler, device ms a "
          "call): " + ", ".join(f"{n} {ms:.4f}"
                                for n, ms in t["passes_ms"].items()))
    return {"worst_of_tol": worst / FA_TOL[torch.bfloat16],
            "max_abs_err": abs_err, **t}


def _ssd_operands(shape, g, *, state=False, exact_s=False):
    """A conv output (b, L, h*P + 2N) in bf16 whose slices are xh, B and
    C, as ``mamba2_apply`` hands them over, and dt, the log-decays, D and
    the initial state (zero, or unit-normal with ``state``) in float32,
    drawn from ``g``.  ``exact_s`` draws B and C from {-1, 0, 1}: then
    S = C.B^T is an integer of at most N in magnitude, exact in bf16 and
    in any order of the sum."""
    b, L, h, P, N, _ = shape
    cuda = dict(device="cuda", generator=g)
    conv = torch.randn(b, L, h * P + 2 * N, **cuda)
    if exact_s:
        conv[..., h * P:] = torch.randint(-1, 2, (b, L, 2 * N), **cuda).float()
    dt = torch.nn.functional.softplus(torch.randn(b, L, h, **cuda)) * 0.5
    A = -(torch.rand(h, **cuda) * 2 + 0.5)
    s0 = torch.randn(b, h, P, N, **cuda) if state else \
        torch.zeros(b, h, P, N, device="cuda")
    return conv.to(torch.bfloat16), [dt, A * dt, torch.randn(h, 1, **cuda),
                                     s0]


def _ssd_split(conv, shape):
    b, L, h, P, N, _ = shape
    return (conv[..., :h * P].reshape(b, L, h, P), conv[..., h * P:h * P + N],
            conv[..., h * P + N:])


def _ssd_grads(fn, conv, ins, dy, dfin, shape):
    """y, the final state and every operand's gradient through ``fn``
    (``mamba2._ssd`` or the plain loop) under autograd."""
    h, P, N, Q = shape[2:]
    c = conv.detach().requires_grad_()
    rest = [t.detach().requires_grad_() for t in ins]
    y, fin = fn(*_ssd_split(c, shape), *rest, Q)
    gc, *gr = torch.autograd.grad((y, fin), [c, *rest], (dy, dfin))
    return [y, fin, gc[..., :h * P], gc[..., h * P:h * P + N],
            gc[..., h * P + N:], *gr]


def _ssd_times(ss, measure, shape, g) -> dict:
    """The kernels' and the plain loop's forward and backward ms at
    ``shape`` in bf16: the forward through ``ss.forward``, the backward
    through ``ss.backward`` on what it kept, the plain loop's forward
    under no_grad and its backward as autograd's less that."""
    b, L, h, P, N, Q = shape
    conv, ins = _ssd_operands(shape, g)
    dy = torch.randn(b, L, h, P, device="cuda", generator=g)
    dfin = torch.randn(b, h, P, N, device="cuda", generator=g)
    xh, B, C = _ssd_split(conv, shape)
    args = (xh, B, C, *ins)
    _, _, Lc, S, Hs = ss.forward(*args, Q)
    fwd = measure.time_cuda(lambda: ss.forward(*args, Q), warmup=2,
                            iters=5, reps=3).wall_s * 1e3
    bwd = measure.time_cuda(
        lambda: ss.backward(xh, B, C, ins[0], Lc, ins[2], S, Hs, dy, dfin,
                            Q), warmup=2, iters=5, reps=3).wall_s * 1e3
    del Lc, S, Hs
    with torch.no_grad():
        p_fwd = measure.time_cuda(lambda: ss.plain(*args, Q), warmup=1,
                                  iters=2, reps=3).wall_s * 1e3
    leaves = [t.detach().requires_grad_() for t in args]

    def plain_step():
        y, fin = ss.plain(*leaves, Q)
        torch.autograd.grad((y, fin), leaves, (dy, dfin))
    p_all = measure.time_cuda(plain_step, warmup=1, iters=2,
                              reps=3).wall_s * 1e3
    torch.cuda.empty_cache()
    return {"ms": fwd, "backward_ms": bwd, "plain_ms": p_fwd,
            "plain_backward_ms": p_all - p_fwd}


def _ssd_prefill(ss, mamba2, shape, g) -> dict:
    """A serving prefill's scan at ``shape`` (one row, a non-zero cache
    state, no gradient) through ``mamba2._ssd`` and through the plain
    loop: each one's ms (one timed call after one untimed) and the
    device memory it held above its operands at its peak, in GiB."""
    conv, ins = _ssd_operands(shape, g, state=True)
    args = (*_ssd_split(conv, shape), *ins, shape[-1])
    out = {}
    for name, fn in (("kernel", mamba2._ssd), ("plain", ss.plain)):
        with torch.no_grad():
            fn(*args)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0, t1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            t0.record()
            fn(*args)
            t1.record()
            torch.cuda.synchronize()
        out[f"{name}_ms"] = t0.elapsed_time(t1)
        out[f"{name}_transient_gib"] = \
            (torch.cuda.max_memory_allocated() - base) / 2**30
        torch.cuda.empty_cache()
    return out


def ssd_phase(measure, h100, card: str) -> dict:
    """Phase 3b: the SSD scan at SSD_CELL in bf16 (xh, B and C slices of
    one conv output, a zero initial state, unit-normal dy and final state
    gradient from SEED) through the main path's entry ``mamba2._ssd``
    against the plain loop under autograd, forward and backward, within
    SSD_TOL; two backward runs bitwise equal; the route counters, set to
    zero before those two runs, read 2 kernel forwards and 2 kernel
    backwards and no plain one.  Two witnesses of the bf16 limits, each
    against the plain loop: B and C drawn from {-1, 0, 1} (S exact on both
    sides) and a unit-normal initial state.  Then the kernels' forward and
    backward ms beside their FP32 floor (``ssd_scan.flops`` at the machine
    file's FP32 peak) and the plain loop's, at SSD_CELL and at the other
    shapes of SSD_OTHER, and a 524,288-token prefill's ms and transient
    memory on both routes."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import mamba2
    b, L, h, P, N, Q = SSD_CELL
    g = torch.Generator("cuda").manual_seed(SEED)
    conv, ins = _ssd_operands(SSD_CELL, g)
    dy = torch.randn(b, L, h, P, device="cuda", generator=g)
    dfin = torch.randn(b, h, P, N, device="cuda", generator=g)
    names = ("y", "final", "xh", "B", "C", "dt", "l_t", "Dp", "state")

    def rel(got, want):
        return {n: (a.float() - w.float()).abs().max().item()
                / max(w.float().abs().max().item(), 1e-30)
                for n, a, w in zip(names, got, want)}

    fwd_counts = ss.ssd_scan.launches_by_route
    bwd_counts = ss.ssd_scan.backward_calls_by_route
    for r in fwd_counts:
        fwd_counts[r] = bwd_counts[r] = 0
    ss.ssd_scan.launches = 0
    got = _ssd_grads(mamba2._ssd, conv, ins, dy, dfin, SSD_CELL)
    again = _ssd_grads(mamba2._ssd, conv, ins, dy, dfin, SSD_CELL)
    torch.cuda.synchronize()
    counts = {"launches": ss.ssd_scan.launches,
              "launches_by_route": dict(fwd_counts),
              "backward_calls_by_route": dict(bwd_counts)}
    print(f"  route counters over two runs through mamba2._ssd: {counts}")
    if counts != {"launches": 2, "launches_by_route": {"kernel": 2,
                                                       "plain": 0},
                  "backward_calls_by_route": {"kernel": 2, "plain": 0}}:
        raise SmokeError("3b: the SSD scan did not take the kernels")
    if not all(torch.equal(a, w) for a, w in zip(got, again)):
        raise SmokeError("3b: two SSD backward runs differ in bits")
    del again
    err = rel(got, _ssd_grads(ss.plain, conv, ins, dy, dfin, SSD_CELL))
    del got
    witness = {}
    for name, kw in (("exact S", {"exact_s": True}),
                     ("initial state", {"state": True})):
        c2, i2 = _ssd_operands(SSD_CELL, g, **kw)
        witness[name] = rel(_ssd_grads(mamba2._ssd, c2, i2, dy, dfin,
                                       SSD_CELL),
                            _ssd_grads(ss.plain, c2, i2, dy, dfin, SSD_CELL))
        del c2, i2
        torch.cuda.empty_cache()
    for label, r in (("", err), *((f" ({n})", w) for n, w in
                                  witness.items())):
        print(f"  SSD scan {SSD_CELL} bf16{label} on {card}: kernel "
              "against the plain loop, |diff| / max: "
              + ", ".join(f"{n} {v:.2e}" for n, v in r.items()))
    print("  two backward runs bitwise equal")
    bad = {f"{label} {n}": v for label, r in (("", err), *witness.items())
           for n, v in r.items() if not v <= SSD_TOL[n]}
    if bad:
        raise SmokeError(f"3b: SSD kernels off the plain loop beyond "
                         f"SSD_TOL: {bad}")
    del conv, ins, dy, dfin
    torch.cuda.empty_cache()
    peak = h100.peak_flops["FP32"]
    shapes = {"mamba2-2.7b": SSD_CELL, **SSD_OTHER}
    times = {}
    for name, shape in shapes.items():
        t = times[name] = _ssd_times(ss, measure, shape, g)
        f_fwd, f_bwd = ss.flops(*shape)
        t["bound_ms"], t["backward_bound_ms"] = (f_fwd / peak * 1e3,
                                                 f_bwd / peak * 1e3)
        print(f"  {name} {shape}: forward {t['ms']:.4f} ms "
              f"({t['bound_ms'] / t['ms']:.1%} of its FP32 floor "
              f"{t['bound_ms']:.4f} ms: {f_fwd / 1e9:.1f} GFLOP at "
              f"{peak / 1e12:.0f} TFLOP/s), plain loop {t['plain_ms']:.4f} "
              f"ms; backward {t['backward_ms']:.4f} ms "
              f"({t['backward_bound_ms'] / t['backward_ms']:.1%} of "
              f"{t['backward_bound_ms']:.4f} ms), plain loop's autograd "
              f"{t['plain_backward_ms']:.4f} ms")
    prefill = _ssd_prefill(ss, mamba2, SSD_PREFILL, g)
    print(f"  prefill {SSD_PREFILL} under no_grad: kernels "
          f"{prefill['kernel_ms']:.2f} ms holding "
          f"{prefill['kernel_transient_gib']:.3f} GiB above the operands; "
          f"plain loop {prefill['plain_ms']:.2f} ms holding "
          f"{prefill['plain_transient_gib']:.3f} GiB")
    cell = times["mamba2-2.7b"]
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "repro.models.mamba2's chunked SSD loop (plain jnp, "
                        "no Pallas kernel)",
            "shape": list(SSD_CELL), "max_rel_err": err,
            "witness_rel_err": witness, **cell, "bound_by":
                "operations (FP32)", "other_shapes": {
                n: {"shape": list(shapes[n]), **times[n]}
                for n in SSD_OTHER}, "prefill": {"shape": list(SSD_PREFILL),
                                                 **prefill}, **counts}


def backward_times(fa, space, measure, h100, q, k, v, do) -> dict:
    """The backward kernel's CUDA-event ms on (q, k, v, dO), causal at
    q_offset 0, beside ``attention_backward``'s, SDPA's forward plus
    backward, SDPA's backward alone (its forward run once outside the
    timed call) and ``attention_backward_bound`` (10·d flops per visible
    pair: two and a half attention passes)."""
    t_k = measure.time_cuda(
        lambda: fa.flash_attention_backward(q, k, v, do, causal=True,
                                            q_offset=0),
        warmup=2, iters=5, reps=5).wall_s * 1e3
    t_p = measure.time_cuda(
        lambda: fa.attention_backward(q, k, v, do, causal=True, q_offset=0),
        warmup=1, iters=2, reps=3).wall_s * 1e3
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=True).backward(do)
    t_s = measure.time_cuda(sdpa_fwd_bwd, warmup=2, iters=5,
                            reps=5).wall_s * 1e3
    out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True)

    def sdpa_bwd():
        torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
    t_sb = measure.time_cuda(sdpa_bwd, warmup=2, iters=5,
                             reps=5).wall_s * 1e3
    del out
    bound = space.attention_backward_bound(q, k, causal=True, q_offset=0,
                                           machine=h100)
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_s,
            "library_backward_ms": t_sb, "bound_ms": bound.seconds * 1e3,
            "bound_by": bound.by}


def backward_passes_ms(fa, q, k, v, do, calls: int = 5) -> dict:
    """Device ms a call of each of the backward kernel's launches (the
    rows pass, the fused pass, the dQ cast) over ``calls`` calls, from
    ``torch.profiler`` (the process's first profile: the flash phase's)."""
    from torch.profiler import ProfilerActivity, profile as prof
    fa.flash_attention_backward(q, k, v, do, causal=True, q_offset=0)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            fa.flash_attention_backward(q, k, v, do, causal=True, q_offset=0)
        torch.cuda.synchronize()
    ms = {"rows": 0.0, "fused": 0.0, "dq": 0.0}
    for e in p.events():
        m = BWD_PASS.search(e.name)
        if m and _is_cuda(e):
            ms[m[1]] += (e.time_range.end - e.time_range.start) / 1e3 / calls
    if not all(ms.values()):
        raise SmokeError(f"the profiler saw the backward's passes as {ms}")
    return ms


def print_ratios(rep, fa, config) -> None:
    """measured / predicted of every measured candidate, with its route."""
    for c in rep.measured_outcomes:
        bq, bkv = c.params["block_q"], c.params["block_kv"]
        route = fa.route(bq, bkv, config["head_dim"], config["dtype"])
        meas = c.measured_s
        ratio = "-" if meas is None else f"{meas / c.predicted_s:.3f}"
        print(f"    ({bq}, {bkv}) {route:6s} predicted "
              f"{c.predicted_s * 1e3:.4f} ms, measured "
              + ("-" if meas is None else f"{meas * 1e3:.4f} ms")
              + f", measured/predicted {ratio}")


def calibration_copy(tune_mod) -> pathlib.Path:
    """Where the calibrated copy of the H100 machine file goes."""
    return ROOT / "build" / "chip_smoke" / tune_mod.machine_yaml_path(
        "H100").name


def write_calibration(tune_mod, machine_mod, calibration: dict,
                      fresh: bool) -> pathlib.Path:
    """Merge ``calibration`` into :func:`calibration_copy` (made anew from
    the tracked file when ``fresh`` or missing): each family's and each
    level's factor stays beside the others', a factor of the same name is
    replaced.  The tracked file is never written.  Returns the copy's
    path."""
    cal_copy = calibration_copy(tune_mod)
    cal_copy.parent.mkdir(parents=True, exist_ok=True)
    if fresh or not cal_copy.exists():
        cal_copy.write_text(tune_mod.machine_yaml_path("H100").read_text())
    prev = machine_mod.Machine.from_yaml(cal_copy).calibration or {}
    merged = {**prev, **calibration}
    for key in ("levels", "time", "meta"):
        if key in prev or key in calibration:
            merged[key] = {**prev.get(key, {}), **calibration.get(key, {})}
    tune_mod.apply_calibration(cal_copy, merged)
    return cal_copy


def tune_path(fa, space, tune_mod, measure, machine_mod, config: dict,
              expect: str, calibrate: bool) -> dict:
    """The tuner at ``config``, with calibration written to a copy of the
    machine file under build/ when ``calibrate``, and one launch at the
    chosen blocks, which must take the ``expect`` route; on bf16x3 the
    split pass is also timed alone."""
    rep = tune_mod.tune("flash_attention", "H100", config=config, top_k=4,
                        isolate=True, device="cuda")
    print("  " + rep.render().replace("\n", "\n  "))
    print_ratios(rep, fa, config)
    if rep.n_failed or rep.measured_chosen_s is None:
        raise SmokeError("tune flash_attention measured no candidate or "
                         "lost one")
    factor = None
    if calibrate:
        cal_copy = write_calibration(tune_mod, machine_mod, rep.calibration,
                                     fresh=False)
        reloaded = machine_mod.Machine.from_yaml(cal_copy)
        factor = reloaded.calibration_factor("time", "flash_attention")
        kept = sorted(reloaded.calibration["time"])
        print(f"  calibration merged into {cal_copy.relative_to(ROOT)}; "
              f"reloaded: time[flash_attention] = {factor:.6g}, time "
              f"factors {kept}, levels {reloaded.calibration.get('levels')}")
        if not set(MAIN) <= set(kept):
            raise SmokeError(f"the stencil factors did not survive: {kept}")
    sp = space.resolve_space("flash_attention", "H100", **config)
    q, k, v = sp.inputs("cuda")
    bq, bkv = rep.chosen_params["block_q"], rep.chosen_params["block_kv"]
    route = fa.route(bq, bkv, config["head_dim"], q.dtype)
    if route != expect:
        raise SmokeError(f"the tuner chose ({bq}, {bkv}), which takes the "
                         f"{route} route, not {expect}")
    out, ran = routed(fa, lambda: fa.flash_attention(
        q, k, v, block_q=bq, block_kv=bkv))
    if ran != expect:
        raise SmokeError(f"the chosen blocks launched on {ran}")
    t_kernel = measure.time_cuda(
        lambda: fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv),
        warmup=1, iters=3, reps=5)
    run = {"report": rep, "qkv": (q, k, v), "out": out, "route": route,
           "blocks": (bq, bkv), "t_kernel": t_kernel, "factor": factor}
    if route == "bf16x3":
        run["t_split"] = measure.time_cuda(lambda: fa.split_bf16x3(q, k, v),
                                           warmup=1, iters=3, reps=5)
    torch.cuda.synchronize()
    return run


def simt_path(fa, space, measure) -> dict:
    """The same attention in float32 on the CUDA-core route, at
    :data:`SIMT_BLOCKS`, a pair off the bf16x3 set, and timed at
    :data:`SIMT_BLOCKS_BEFORE` too (held against the first)."""
    sp = space.resolve_space("flash_attention", "H100", **GRANITE_F32)
    q, k, v = sp.inputs("cuda")
    times = {}
    for bq, bkv in (SIMT_BLOCKS_BEFORE, SIMT_BLOCKS):
        def call():
            return fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
        out, route = routed(fa, call)
        if route != "simt":
            raise SmokeError(f"f32 attention at {(bq, bkv)} launched on "
                             f"{route}, not simt")
        times[(bq, bkv)] = measure.time_cuda(call, warmup=1, iters=3,
                                             reps=5)
        if (bq, bkv) == SIMT_BLOCKS_BEFORE:
            before = out
    fa_compare(f"granite f32 simt at {SIMT_BLOCKS_BEFORE}", before,
               fa.plain(q, k, v), q.dtype)
    torch.cuda.synchronize()
    return {"report": None, "qkv": (q, k, v), "out": out, "route": route,
            "blocks": SIMT_BLOCKS, "t_kernel": times[SIMT_BLOCKS],
            "t_before": times[SIMT_BLOCKS_BEFORE]}


def flash_report(run: dict, fa, space, measure, h100, card: str,
                 yard: dict) -> dict:
    """Plain-version and SDPA timings (once per dtype, kept in ``yard``:
    every run of a dtype has the same seeded inputs), the bound, and the
    kernels-line entry for one flash main-path run (launches filled in by
    the caller)."""
    q, k, v = run["qkv"]
    rep, route = run["report"], run["route"]
    name = str(q.dtype)[6:]
    err = fa_compare(f"granite {name} {route}", run["out"], fa.plain(q, k, v),
                     q.dtype)
    if name not in yard:
        t_plain = measure.time_cuda(lambda: fa.plain(q, k, v), warmup=1,
                                    iters=2, reps=3)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True)
        # SDPA's causal mask is top-left aligned: it equals the kernel's
        # only at seq_q == seq_kv, which the granite shape has
        fa_compare(f"SDPA yardstick {name}", sdpa(), run["out"], q.dtype)
        yard[name] = (t_plain.wall_s * 1e3, measure.time_cuda(sdpa).wall_s
                      * 1e3)
    plain_ms, lib_ms = yard[name]
    bound = space.attention_bound(q, k, causal=True, machine=h100)
    ms = run["t_kernel"].wall_s * 1e3
    bq, bkv = run["blocks"]
    unit = ("bf16, one pass" if q.dtype == torch.bfloat16
            else "bf16, three passes")
    print(f"  flash_attention {tuple(q.shape)} {name} causal, route {route}"
          f", blocks ({bq}, {bkv}) on {card}:")
    print(f"    kernel   {ms:.4f} ms  ({bound.seconds * 1e3 / ms:.1%} of the "
          f"bound)")
    print(f"    bound    {bound.seconds * 1e3:.4f} ms by {bound.by} "
          f"({bound.ops_s * 1e3:.4f} ms of operations at "
          f"{h100.peak_flops['BF16'] / 1e12:.0f} TFLOP/s, {unit}; "
          f"{bound.bytes / 1e6:.1f} MB at {h100.hbm_bandwidth / 1e12:.2f} "
          f"TB/s, {bound.bytes_s * 1e3:.4f} ms)")
    entry = {"name": FA_ENTRY[route], "route": "cuda",
             "source": f"src/repro_torch/csrc/{fa.SOURCES[route]}.cu",
             "replaces": REPLACES["flash_attention"], "launches": 0,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound.seconds * 1e3, "bound_by": bound.by,
             "library_ms": lib_ms}
    if q.dtype == torch.float32:
        floor = space.attention_bound(q, k, causal=True, machine=h100,
                                      unit="FP32")
        entry["fp32_cores_bound_ms"] = floor.seconds * 1e3
        print(f"    FP32     {floor.seconds * 1e3:.4f} ms, the floor of the "
              f"CUDA cores at {h100.peak_flops['FP32'] / 1e12:.0f} TFLOP/s "
              f"({floor.seconds * 1e3 / ms:.1%} of it)")
        if route == "simt":
            before = run["t_before"].wall_s * 1e3
            entry.update(fp32_floor_share=floor.seconds * 1e3 / ms,
                         sdpa_ratio=ms / lib_ms,
                         before_blocks=list(SIMT_BLOCKS_BEFORE),
                         before_blocks_ms=before)
            print(f"    simt     {floor.seconds * 1e3 / ms:.1%} of the FP32 "
                  f"floor, {ms / lib_ms:.3f}x SDPA in f32's {lib_ms:.4f} ms;"
                  f" at {SIMT_BLOCKS_BEFORE} (the pair timed before) "
                  f"{before:.4f} ms, {floor.seconds * 1e3 / before:.1%} of "
                  f"the floor, {before / lib_ms:.3f}x SDPA")
    if "t_split" in run:
        split_ms = run["t_split"].wall_s * 1e3
        moved = fa.split_bytes(q.numel(), k.numel())
        split_bound = moved / h100.hbm_bandwidth * 1e3
        entry.update(split_ms=split_ms, split_bound_ms=split_bound)
        print(f"    split    {split_ms:.4f} ms of it, alone ({moved / 1e6:.1f}"
              f" MB, bound {split_bound:.4f} ms by bytes, "
              f"{split_bound / split_ms:.1%} of it); the attention kernel "
              f"{ms - split_ms:.4f} ms")
    print(f"    plain    {plain_ms:.4f} ms")
    print(f"    library  {lib_ms:.4f} ms (scaled_dot_product_attention, "
          "yardstick only)")
    if rep is not None:
        print(f"    tuner predicted {rep.predicted_chosen_s * 1e3:.4f} ms "
              f"(measured/predicted "
              f"{ms / (rep.predicted_chosen_s * 1e3):.3f})")
    print(f"    max abs err vs plain {err:.3e}")
    return entry


def model_path(model: str, dtype: str, fa, space, measure, h100,
               card: str) -> dict:
    """One model's attention in ``dtype`` at ``default_config``, which must
    launch on the dtype's tensor-core route; held against the plain
    version and timed beside the CUDA-core kernel at the pair it took
    before, the plain version, SDPA and the bound.  Returns the
    kernels-line entry (launches filled in by the caller)."""
    config = {**REAL_MODELS[model], "dtype": dtype}
    sp = space.resolve_space("flash_attention", "H100", **config)
    q, k, v = sp.inputs("cuda")
    d = config["head_dim"]
    expect = TC_ROUTE[q.dtype]
    bq, bkv = fa.default_config(config["seq_q"], config["seq_kv"], d,
                                q.dtype)
    if fa.route(bq, bkv, d, q.dtype) != expect:
        raise SmokeError(f"{model} {dtype}: default_config ({bq}, {bkv}) "
                         f"takes {fa.route(bq, bkv, d, q.dtype)}, not "
                         f"{expect}")

    def call():
        return fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    sb = SIMT_BEFORE[model]

    def simt():
        return fa.flash_attention(q, k, v, block_q=sb[0], block_kv=sb[1],
                                  force_simt=True)
    out, ran = routed(fa, call)
    if ran != expect:
        raise SmokeError(f"{model} {dtype} at ({bq}, {bkv}) launched on "
                         f"{ran}, where route() says {expect}")
    want = fa.plain(q, k, v)
    err = fa_compare(f"{model} {dtype} {ran}", out, want, q.dtype)
    got_simt, ran_simt = routed(fa, simt)
    if ran_simt != "simt":
        raise SmokeError(f"force_simt=True launched on {ran_simt}")
    simt_err = fa_compare(f"{model} {dtype} simt", got_simt, want, q.dtype)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    fa_compare(f"SDPA yardstick {model} {dtype}", sdpa(), out, q.dtype)
    del want, got_simt
    t_tc = measure.time_cuda(call, warmup=1, iters=3, reps=5).wall_s * 1e3
    t_simt = measure.time_cuda(simt, warmup=0, iters=1,
                               reps=3).wall_s * 1e3
    t_plain = measure.time_cuda(lambda: fa.plain(q, k, v), warmup=1,
                                iters=1, reps=3).wall_s * 1e3
    t_sdpa = measure.time_cuda(sdpa, warmup=1, iters=3, reps=5).wall_s * 1e3
    torch.cuda.synchronize()
    bound = space.attention_bound(q, k, causal=True, machine=h100)
    b_ms = bound.seconds * 1e3
    D = fa.tc_head_dim(d)
    print(f"  {model} {tuple(q.shape)} {dtype} causal on {card}:")
    print(f"    {ran:6s}   {t_tc:.4f} ms at default_config ({bq}, {bkv}), "
          f"{b_ms / t_tc:.1%} of the bound"
          + (f" ({b_ms * D / d / t_tc:.1%} of the head-dim-{D} work it "
             "does)" if D != d else ""))
    print(f"    simt     {t_simt:.4f} ms at {sb}, the pair it ran at before "
          f"({t_simt / t_tc:.1f}x the {ran} time)")
    print(f"    bound    {b_ms:.4f} ms by {bound.by} at head dim {d}")
    print(f"    plain    {t_plain:.4f} ms")
    print(f"    library  {t_sdpa:.4f} ms (scaled_dot_product_attention, "
          "yardstick only)")
    print(f"    max abs err vs plain: {ran} {err:.3e}, simt {simt_err:.3e}")
    return {"name": f"{FA_ENTRY[ran]}[{model}]", "route": "cuda",
            "source": f"src/repro_torch/csrc/{fa.SOURCES[ran]}.cu",
            "replaces": REPLACES["flash_attention"], "launches": 0,
            "max_abs_err": err, "ms": t_tc, "plain_ms": t_plain,
            "bound_ms": b_ms, "bound_by": bound.by, "library_ms": t_sdpa,
            "head_dim": d, "dtype": dtype, "blocks": [bq, bkv],
            "padded_bound_ms": b_ms * D / d, "simt_ms": t_simt,
            "simt_blocks": list(sb), "simt_max_abs_err": simt_err}


def sass_hgmma(_build, name: str) -> int:
    """HGMMA (wgmma) instructions in the SASS of a built library."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise SmokeError(f"cuobjdump -sass failed on {name}: "
                         f"{proc.stderr.strip()[-2000:]}")
    return sum("HGMMA" in ln for ln in proc.stdout.splitlines())


def tc_ptxas(info: dict) -> dict[tuple, tuple[int, int]]:
    """(registers, spill bytes stored) of every tensor-core kernel
    instantiation, keyed (kernel, D, BKV, NWG), from the ptxas report:
    a "Compiling entry function" line, then its spill line, then its
    register line."""
    out, key = {}, None
    for d in info.values():
        for ln in d["ptxas"]:
            m = TC_KERNEL.search(ln)
            if "Compiling" in ln:
                key = (m[1], *map(int, m.groups()[1:])) if m else None
            elif key and SPILL.search(ln):
                out[key] = (0, int(SPILL.search(ln)[1]))
            elif key and USED.search(ln):
                out[key] = (int(USED.search(ln)[1]), out[key][1])
    return out


def backward_ptxas(info: dict) -> dict[tuple, tuple[int, int]]:
    """(registers, spill bytes stored) of every backward kernel
    instantiation, keyed (kernel, D), from the ptxas report."""
    out, key = {}, None
    for ln in info.get("flash_attention_bwd", {}).get("ptxas", []):
        m = BWD_KERNEL.search(ln)
        if "Compiling" in ln:
            key = (m[1], int(m[2])) if m else None
        elif key and SPILL.search(ln):
            out[key] = (0, int(SPILL.search(ln)[1]))
        elif key and USED.search(ln):
            out[key] = (int(USED.search(ln)[1]), out[key][1])
    return out


def simt_ptxas(info: dict) -> dict[tuple, tuple[int, int]]:
    """(registers, spill bytes stored) of every CUDA-core kernel
    instantiation, keyed (dtype, block_q, block_kv, D) for the tiled
    kernel and (dtype, 0, 0, 0) for the general one."""
    out, key = {}, None
    for ln in info.get("flash_attention", {}).get("ptxas", []):
        m = SIMT_KERNEL.search(ln)
        if "Compiling" in ln:
            key = None if not m else (
                "float32" if m[2] == "f" else "bfloat16",
                *(int(x) if x else 0 for x in m.groups()[2:]))
        elif key and SPILL.search(ln):
            out[key] = (0, int(SPILL.search(ln)[1]))
        elif key and USED.search(ln):
            out[key] = (int(USED.search(ln)[1]), out[key][1])
    return out


def simt_triples(fa, space) -> list[tuple[int, int, int]]:
    """Every (block_q, block_kv, head_dim) the smoke launches on the simt
    route: the tiled set, phase 3's cases and its head-dim-100 call
    (``default_config``), the simt candidates of the seq-256 tune spaces,
    phase 6's pairs and phase 7's."""
    out = set(fa.SIMT_TILED_SET)
    out |= {(bq, bkv, d) for d, (bq, bkv), _, _ in SIMT_CASES}
    out.add((*fa.default_config(256, 512, 100, "float32"), 100))
    out |= {(*SIMT_BLOCKS, 128), (*SIMT_BLOCKS_BEFORE, 128)}
    out |= {(*SIMT_BEFORE[m], c["head_dim"]) for m, c in REAL_MODELS.items()}
    for dtype in ("float32", "bfloat16"):
        sp = space.resolve_space("flash_attention", "H100", batch=1,
                                 heads=4, seq_q=256, seq_kv=256,
                                 head_dim=128, causal=True, dtype=dtype)
        cands = sp.candidates()
        out |= {(c.config["block_q"], c.config["block_kv"], 128)
                for c, p in zip(cands, sp.predict(cands))
                if p.feasible and sp.route(c) == "simt"}
    return sorted(out)


def check_simt_build(fa, space, info: dict) -> None:
    """The ptxas report of every CUDA-core instantiation (tiled at each
    triple of the set, general, both types): no spill, and registers that
    hold no fewer CTAs an SM than ``launch_limits`` states (one tiled CTA
    by shared memory; 256 threads at up to 255 registers fit beside it);
    then the library's ``repro_flash_attention_limits`` against
    ``_simt_limits`` at every triple the smoke launches on simt."""
    regs = simt_ptxas(info)
    want = {(t, *k) for k in set(fa.SIMT_TILED_SET) | {(0, 0, 0)}
            for t in ("float32", "bfloat16")}
    for key, (n, spill) in sorted(regs.items()):
        kern = ("general" if not key[1] else
                f"tiled ({key[1]}, {key[2]}, {key[3]})")
        print(f"  flash_attention simt {kern} {key[0]}: {n} registers, "
              f"{spill} bytes spilled")
    if set(regs) != want or any(spill for _, spill in regs.values()):
        raise SmokeError(f"the simt kernels' ptxas report {regs}: missing "
                         "instantiations or spills")
    for key, (n, _) in regs.items():
        if key[1]:
            lim = fa._simt_limits(*key[1:])
            by_regs = 65536 // (fa.THREADS * -(-n // 8) * 8)
            if by_regs < lim.ctas_per_sm:
                raise SmokeError(f"simt {key}: {n} registers hold {by_regs}"
                                 f" CTAs an SM, launch_limits says "
                                 f"{lim.ctas_per_sm}")
    triples = simt_triples(fa, space)

    def tiled(t):
        return (t[0], t[1], fa.simt_head_dim(*t)) in fa.SIMT_TILED_SET
    for t in triples:
        lim = fa._simt_limits(*t)
        got = fa.compiled_simt_limits(*t)
        if not lim.ok or got != (lim.smem_bytes, lim.threads):
            raise SmokeError(f"simt {t}: the library states {got}, "
                             f"_simt_limits {(lim.smem_bytes, lim.threads)}"
                             f" ({lim.reason or 'ok'})")
    print(f"  simt launch limits: the library and _simt_limits agree at all "
          f"{len(triples)} (block_q, block_kv, head_dim) the smoke launches "
          f"on simt, {sum(tiled(t) for t in triples)} of them on the tiled "
          "kernel")


def check_build(_build, fa, info: dict) -> dict[str, int]:
    """The ptxas report (no spill at head dim 256), the HGMMA counts, and
    the tensor-core libraries' launch limits against ``launch_limits``;
    returns the HGMMA count per flash library."""
    for name, d in info.items():
        print(f"  {name}: {d['seconds']:.1f} s")
        for ln in d["ptxas"]:
            ln = BWD_KERNEL.sub(lambda m: f"{m[1]}<D={m[2]}>", ln)
            ln = SIMT_KERNEL.sub(lambda m: f"{m[1]}<" + (
                "float" if m[2] == "f" else "bf16") + (
                f", BQ={m[3]}, BKV={m[4]}, D={m[5]}>" if m[3] else ">"), ln)
            print("    " + TC_KERNEL.sub(
                lambda m: f"{m[1]}<D={m[2]}, BKV={m[3]}, NWG={m[4]}>", ln))
    regs = tc_ptxas(info)
    new = {k: v for k, v in regs.items() if k[1] == 256}
    if not new:
        raise SmokeError("the ptxas report names no head-dim-256 kernel")
    for (kern, D, bkv, nwg), (n, spill) in sorted(new.items()):
        print(f"  {kern}<D={D}, BKV={bkv}, NWG={nwg}>: {n} registers, "
              f"{spill} bytes spilled")
        if spill:
            raise SmokeError(f"{kern}<D={D}, BKV={bkv}, NWG={nwg}> spills "
                             f"{spill} bytes")
    bwd = backward_ptxas(info)
    for (kern, D), (n, spill) in sorted(bwd.items()):
        print(f"  {kern}<D={D}>: {n} registers, {spill} bytes spilled")
    if len(bwd) != 3 * len(fa.BACKWARD_HEAD_DIMS) or \
            any(spill for _, spill in bwd.values()):
        raise SmokeError(f"the backward kernels' ptxas report {bwd}: "
                         "missing instantiations or spills")
    for d in fa.BACKWARD_HEAD_DIMS + (112,):
        got = fa.compiled_backward_limits(d)
        want = (*fa.backward_smem_bytes(d), *fa.BACKWARD_THREADS)
        if got != want:
            raise SmokeError(f"backward at head_dim {d}: the library states "
                             f"{got}, backward_smem_bytes {want}")
    print(f"  backward launch limits: the library and backward_smem_bytes "
          f"agree at head dims {fa.BACKWARD_HEAD_DIMS + (112,)}")
    sources = (*fa.SOURCES.values(), fa.BACKWARD_SOURCE)
    hgmma = {src: sass_hgmma(_build, src) for src in sources}
    print(f"  HGMMA instructions in the SASS: {hgmma}")
    for src in (*(fa.SOURCES[r] for r in TC_ROUTE.values()),
                fa.BACKWARD_SOURCE):
        if hgmma[src] <= 0:
            raise SmokeError(f"the {src} library's SASS has no HGMMA "
                             "instruction")
    for route, dtype, compiled in (
            ("wgmma", torch.bfloat16, fa.compiled_wgmma_limits),
            ("bf16x3", torch.float32, fa.compiled_bf16x3_limits)):
        n = refused = 0
        for d in fa.WGMMA_HEAD_DIMS + (112,):
            for bkv in fa.WGMMA_BLOCK_KV:
                for bq in fa.WGMMA_BLOCK_Q:
                    if fa.route(bq, bkv, d, dtype) != route:
                        try:        # the library must refuse it too
                            compiled(bq, bkv, d)
                        except RuntimeError:
                            refused += 1
                            continue
                        raise SmokeError(f"the {route} library states "
                                         f"limits for ({bq}, {bkv}) d={d}, "
                                         "off its set")
                    lim = fa.launch_limits(bq, bkv, d, dtype)
                    got = compiled(bq, bkv, d)
                    if lim.route != route or \
                            got != (lim.smem_bytes, lim.threads):
                        raise SmokeError(
                            f"{route} ({bq}, {bkv}) d={d}: the library "
                            f"states {got}, launch_limits "
                            f"{(lim.smem_bytes, lim.threads)} on "
                            f"{lim.route}")
                    n += 1
        print(f"  {route} launch limits: the library and launch_limits "
              f"agree on all {n} (block_q, block_kv, head_dim) of the set, "
              f"at the instantiated head dims and at 112; {refused} off "
              "the set refused by both")
    return hgmma


def check_stencil_build(_build, ops, stencil, info: dict) -> None:
    """No stencil kernel instantiation spills, and the advisor's shared
    bytes and threads agree with each library's ``repro_<kernel>_limits``
    at the main-path and ragged shapes."""
    key, spills = None, {}
    for name in MAIN:
        for ln in info[name]["ptxas"]:
            m = STENCIL_KERNEL.search(ln)
            if "Compiling" in ln:
                key = f"{m[1]}<C={m[2]}>" if m else None
            elif key and SPILL.search(ln):
                spills[key] = int(SPILL.search(ln)[1])
    print(f"  stencil spill stores (bytes): {spills}")
    if len(spills) != 2 * 4 or any(spills.values()):
        raise SmokeError(f"a stencil kernel spills or is missing: {spills}")
    for name in MAIN:
        mod = stencil.family(name).module
        for shape in RAGGED + [MAIN[name]]:
            plan = ops.blocking.stencil_cta_tile(mod.RADIUS, shape, mod.OWN)
            got = _build.compiled_limits(name, plan.launch)
            if got != (plan.smem_bytes, plan.threads):
                raise SmokeError(f"{name} {shape} plan {plan.launch}: the "
                                 f"library states {got}, the advisor "
                                 f"{(plan.smem_bytes, plan.threads)}")
        print(f"  {name}: advisor and repro_{name}_limits agree at "
              f"{len(RAGGED) + 1} shapes; main-path plan "
              f"{ops.blocking.stencil_cta_tile(mod.RADIUS, MAIN[name], mod.OWN).launch}")


def stencil_tune(name: str, tune_mod, space, stencil, machine_mod,
                 fresh: bool) -> dict:
    """``tune <name>`` on the H100 machine file at the space's defaults,
    measured in child processes on the card; the calibration is merged
    into the build copy and the candidates are predicted again from it;
    one run of the chosen candidate in this process, counted and held
    against the plain version."""
    fam = stencil.family(name)
    wrapper = getattr(fam.module, name)
    rep = tune_mod.tune(name, "H100", top_k=STENCIL_TOP_K, isolate=True,
                        device="cuda")
    print("  " + rep.render().replace("\n", "\n  "))
    measured = rep.measured_outcomes
    if rep.n_failed or len(measured) < STENCIL_TOP_K \
            or rep.measured_default_s is None:
        raise SmokeError(f"tune {name}: {rep.n_failed} candidates failed, "
                         f"{len(measured)} measured, default measured: "
                         f"{rep.measured_default_s is not None}")
    cal_copy = write_calibration(tune_mod, machine_mod, rep.calibration,
                                 fresh)
    again = tune_mod.tune(name, str(cal_copy), measure=False)
    after = {c.params["n"]: c.predicted_s for c in again.candidates
             if c.predicted_s is not None}
    sp = space.resolve_space(name, "H100")
    print(f"  {'n':>4s} {'repeats':>7s} {'predicted ms':>12s} "
          f"{'measured ms':>11s} {'meas/pred':>9s} {'calibrated':>10s}")
    for c in sorted(measured, key=lambda c: c.params["n"]):
        n = c.params["n"]
        print(f"  {n:4d} {sp.repeats(n):7d} {c.predicted_s * 1e3:12.6f} "
              f"{c.measured_s * 1e3:11.6f} "
              f"{c.measured_s / c.predicted_s:9.3f} "
              f"{c.measured_s / after[n]:10.3f}")
    before = tune_mod.prediction_error(
        [(c.predicted_s, c.measured_s) for c in measured])
    cal_err = tune_mod.prediction_error(
        [(after[c.params["n"]], c.measured_s) for c in measured])
    print(f"  rms_log before calibration {before['rms_log']:.4f}, after "
          f"{cal_err['rms_log']:.4f} (time[{name}] = "
          f"{rep.calibration['time'][name]:.6g}, levels "
          f"{rep.calibration.get('levels')})")
    print(f"  chosen n={rep.chosen_params['n']} "
          f"{rep.measured_chosen_s * 1e3:.6f} ms against the default "
          f"n={rep.default_params['n']} {rep.measured_default_s * 1e3:.6f} "
          f"ms per sample: {rep.speedup_vs_default:.3f}x")
    n = rep.chosen_params["n"]
    wrapper.launches = 0
    out = sp.runner({"n": n}, "cuda")()
    torch.cuda.synchronize()
    launches = wrapper.launches
    args = stencil.make_inputs(name, sp.shape(n), "cuda")
    err, _ = compare(name, out, fam.module.plain(*args), fam.module.RADIUS)
    print(f"  chosen n={n} once in this process: {launches} launches of "
          f"the {name} kernel (repeats {sp.repeats(n)}), max abs err vs "
          f"plain {err:.3e}")
    if launches != sp.repeats(n) or launches <= 0:
        raise SmokeError(f"tune {name}: the chosen candidate launched the "
                         f"kernel {launches} times, not {sp.repeats(n)}")
    return {"report": rep.to_dict(), "launches": launches,
            "max_abs_err": err, "rms_log_before": before["rms_log"],
            "rms_log_after": cal_err["rms_log"],
            "predicted_after_ms": {n: s * 1e3 for n, s in after.items()}}


def regime_changes(name: str, space, api, blocking, h100) -> list[int]:
    """The block edges of the space's range at which ``grid_search``'s
    saturated score at all SMs changes (the LC regime boundaries the
    candidate range must straddle)."""
    sp = space.resolve_space(name, "H100")
    vals = [c.config["n"] for c in sp.candidates()]
    kernel = api.load_kernel(f"trace:{name}", {"M": sp.config["m"]}, 4)
    sms = int(h100.extra["SM count"])
    gs = blocking.grid_search(kernel, h100, [("N", vals)],
                              cores=list(range(1, sms + 1)))
    last = gs.scores[:, -1]
    changes = [vals[i + 1] for i in range(len(vals) - 1)
               if last[i] != last[i + 1]]
    print(f"  {name}: grid_search at {sms} SMs over n = {vals[0]}.."
          f"{vals[-1]} changes regime at n = {changes}")
    return changes


def block_sizes(api, blocking, h100) -> dict:
    """``lc_block_size`` (safety 0.5, the default) per level of the H100
    machine file, and of the L2's share per SM when all 132 run, for
    both traced kernels at 4 bytes and the paper's C long-range listing
    at its own 8-byte doubles."""
    kernels = {
        "stencil3d7pt traced, 4 B, M=16":
            api.load_kernel("trace:stencil3d7pt", {"M": 16}, 4),
        "longrange3d traced, 4 B, M=16":
            api.load_kernel("trace:longrange3d", {"M": 16}, 4),
        "stencil_3d_long_range.c, 8 B, M=130":
            api.load_kernel("stencil_3d_long_range.c", {"M": 130}),
    }
    levels = {lv.name: lv.size_bytes for lv in h100.levels}
    sms = int(h100.extra["SM count"])
    levels[f"L2/{sms}"] = h100.levels[-1].size_bytes / sms
    out = {}
    for what, k in kernels.items():
        out[what] = {lvl: blocking.lc_block_size(k, size)
                     for lvl, size in levels.items()}
        print(f"  lc_block_size {what:38s} " + ", ".join(
            f"{lvl} N <= {b}" for lvl, b in out[what].items()))
    return out


def timed_volumes(predict, kernel, h100, **kw):
    t0 = time.perf_counter()
    vol = predict(kernel, h100, **kw)
    return vol, time.perf_counter() - t0


def sim_and_ports(measured_ms: dict, stencil, h100, predictors, cachesim,
                  incore) -> dict:
    """Phase 4c: per main-path stencil, traced at 4 bytes at phase 4's
    shape, the bytes per iteration per level from LC at all SMs and from
    the cache simulator at the JAX package's default warm-up and at one
    that covers the 3D layer condition (cut to what fits the phase's
    budget, timed by a probe), with ECM and Roofline from each beside
    phase 4's measured time; then the ``ports`` in-core model against
    ``simple`` at SP and at the DP default.  Host code only: it launches
    nothing."""
    t_start = time.perf_counter()
    backend = cachesim.resolve_backend(h100)
    if backend != "vector":
        raise SmokeError(f"SIM resolves to the {backend!r} backend on "
                         f"{h100.name}, not 'vector'")
    sms = int(h100.extra["SM count"])
    names = h100.level_names
    out = {}
    for name, ms in measured_ms.items():
        shape, n = MAIN[name], MAIN[name][1]
        k = stencil.kernel(name, shape)
        rows = {}
        lc, lc_s = timed_volumes(predictors.predict_volumes, k, h100,
                                 predictor="LC", cores=sms)
        rows[f"LC at {sms} SMs"] = (lc, lc_s, None)
        for what, n_rows in (("default", None),
                             ("probe", SIM_PROBE_ROWS)):
            kw = {} if n_rows is None else {"warmup_rows": n_rows}
            vol, sec = timed_volumes(predictors.predict_volumes, k, h100,
                                     predictor="SIM", sim_kwargs=kw)
            if vol.params["backend"] != "vector":
                raise SmokeError(f"{name}: SIM ran on the "
                                 f"{vol.params['backend']!r} backend")
            rows[f"SIM {what}"] = (vol, sec, vol.params["warmup_rows"])
        want = SIM_DEEP_ROWS[name](n)
        left = SIM_BUDGET_S - SIM_MARGIN_S - (time.perf_counter() - t_start)
        per_row = rows["SIM probe"][1] / SIM_PROBE_ROWS
        deep = min(want, max(SIM_PROBE_ROWS, int(left / per_row)))
        vol, sec = timed_volumes(predictors.predict_volumes, k, h100,
                                 predictor="SIM",
                                 sim_kwargs={"warmup_rows": deep})
        label = "SIM 3D LC" if deep == want else f"SIM cut of {want}"
        rows[label] = (vol, sec, deep)
        print(f"  {name} {shape} fp32 traced at 4 B, phase 4 measured "
              f"{ms:.4f} ms; bytes per iteration into each level from the "
              f"next one out, host seconds per prediction")
        print("    " + f"{'':20s}" + "".join(f"{lv:>9s}" for lv in names)
              + f" {'host s':>7s} {'rows':>5s} {'ECM ms':>8s} "
                f"{'meas/pred':>9s} {'Roofl ms':>8s} {'meas/pred':>9s}")
        res = {"measured_ms": ms, "deep_rows_wanted": want,
               "deep_rows_run": deep, "predictions": {}}
        for label, (vol, sec, n_rows) in rows.items():
            pred = stencil.predict_seconds(name, shape, h100, volumes=vol)
            ecm_ms, roof_ms = pred.ecm_s * 1e3, pred.roofline_s * 1e3
            print("    " + f"{label:20s}" + "".join(
                f"{vol.volume(lv):9.3f}" for lv in names)
                + f" {sec:7.2f} {'-' if n_rows is None else n_rows:>5} "
                  f"{ecm_ms:8.4f} {ms / ecm_ms:9.3f} {roof_ms:8.4f} "
                  f"{ms / roof_ms:9.3f}")
            res["predictions"][label] = {
                "bytes_per_it": dict(vol.bytes_per_it), "params":
                dict(vol.params), "host_s": sec, "ecm_ms": ecm_ms,
                "roofline_ms": roof_ms, "ecm": pred.ecm.notation()}
        ic = {"simple SP": incore.analyze(k, h100, "simple", precision="SP"),
              "simple DP": incore.analyze(k, h100, "simple"),
              "ports": incore.analyze(k, h100, "ports")}
        for label, r in ic.items():
            print(f"    in-core {label:10s} T_OL {r.t_ol:6.3f}  T_nOL "
                  f"{r.t_nol:6.3f}  T_lat {r.t_latency:6.3f} cy per "
                  f"{r.unit_iterations} it, critical path "
                  f"{r.critical_path:5.1f} cy, {r.bound} bound")
        p, sp = ic["ports"], ic["simple SP"]
        if (p.t_ol, p.t_nol) != (sp.t_ol, sp.t_nol):
            raise SmokeError(f"{name}: ports (T_OL {p.t_ol}, T_nOL "
                             f"{p.t_nol}) disagrees with simple at SP "
                             f"(T_OL {sp.t_ol}, T_nOL {sp.t_nol})")
        ports = stencil.predict_seconds(name, shape, h100, incore="ports")
        print(f"    occupation {p.port_occupation}; ECM [LC] [ports] "
              f"{ports.ecm_s * 1e3:.4f} ms (measured/predicted "
              f"{ms / (ports.ecm_s * 1e3):.3f})")
        res["incore"] = {label: r.to_dict() for label, r in ic.items()}
        res["ecm_lc_ports_ms"] = ports.ecm_s * 1e3
        out[name] = res
    return out


# ----------------------------------------------------------------------
# phase 8: the analysis tier (lint, reports, the result store, its worker
# pool and the tune served from the store), driven from this process,
# which holds the card's context
# ----------------------------------------------------------------------

def cli_run(cli, argv: list) -> tuple[int, str, float]:
    """``python -m repro_torch ARGV`` in this process: exit code, standard
    output and host seconds."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def _normal(x):
    """A value as it reads back from JSON (tuples become lists)."""
    return json.loads(json.dumps(x, sort_keys=True))


def lint_tier(cli) -> dict:
    """8a: ``lint`` on the paper's listings and the traced stencils at the
    main-path sizes, and ``machine validate`` on the bundled files."""
    counts: dict[str, int] = {}
    for src, consts in LINT_SOURCES.items():
        defines = [a for n, v in consts.items() for a in ("-D", n, str(v))]
        rc, out, _ = cli_run(cli, ["lint", src, "-m", "H100", "--json"]
                             + defines)
        rep = json.loads(out)
        codes = [d["code"] for d in rep["diagnostics"]]
        print(f"  lint {src} {consts}: exit {rc}, {rep['errors']} errors, "
              f"{rep['warnings']} warnings, codes {codes}")
        if rc != 0 or rep["errors"] or "L000" in codes:
            raise SmokeError(f"lint {src}: exit {rc}, codes {codes}")
        for d in rep["diagnostics"]:
            counts[d["severity"]] = counts.get(d["severity"], 0) + 1
    rc, out, _ = cli_run(cli, ["machine", "validate"])
    print("  machine validate: exit", rc, "|", out.strip().replace(
        "\n", " | "))
    if rc != 0:
        raise SmokeError(f"machine validate exited {rc}")
    print(f"  findings by severity: {counts or 'none'}")
    return counts


def child_cli(argv: list) -> tuple[int, str, float, float]:
    """``repro_torch.cli.main(ARGV)`` in a fresh Python process: exit code,
    standard output, the seconds of the call in the child (no warm cache
    of this process helps it) and the child's wall seconds.  The child's
    main module is ``-c`` code, which spawned workers do not re-run, as
    with ``python -m repro_torch``: its pool's children import what a
    user's do, and no torch."""
    code = ("import sys, time\n"
            "from repro_torch import cli\n"
            "t0 = time.perf_counter()\n"
            "rc = cli.main(sys.argv[1:])\n"
            "print(time.perf_counter() - t0, file=sys.stderr)\n"
            "sys.exit(rc)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code] + argv,
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    wall = time.perf_counter() - t0
    try:
        call_s = float(proc.stderr.strip().splitlines()[-1])
    except (IndexError, ValueError):
        raise SmokeError(f"child {argv[:2]} failed (exit {proc.returncode})"
                         f": {proc.stderr[-400:]}") from None
    return proc.returncode, proc.stdout, call_s, wall


def analyze_tier(cli, api, store: pathlib.Path) -> dict:
    """8b: ``python -m repro_torch analyze`` in a child process against
    this process's ``analyze``, bit for bit with the ``--cores`` keys;
    then cold and warm through the store, each in a fresh child."""
    want = []
    for model in ANALYZE["models"]:
        res = api.analyze(ANALYZE["source"], "H100", model,
                          constants=ANALYZE["constants"],
                          cores=ANALYZE["cores"])
        d = res.to_dict()
        if hasattr(res, "scaling_curve"):
            c = ANALYZE["cores"]
            d.update(cores=c, performance_at_cores=res.performance_flops(c),
                     scaling_curve=res.scaling_curve(
                         max(c, res.saturation_cores)))
        want.append(d)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch"]
                          + ANALYZE_ARGV + ["--json"], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0 or json.loads(proc.stdout) != _normal(want):
        raise SmokeError(f"analyze in a child process (exit "
                         f"{proc.returncode}) differs from this process's: "
                         f"{proc.stderr[-400:]}")
    print(f"  python -m repro_torch {' '.join(ANALYZE_ARGV)} --json: exit "
          f"0 in {child_s:.2f} s, equal to this process's analyze() "
          "bit for bit")
    runs = [child_cli(ANALYZE_ARGV + ["--cache-dir", str(store), "--stats",
                                      "--json"]) for _ in range(2)]
    (rc0, out0, cold_s, cold_wall), (rc1, out1, warm_s, warm_wall) = runs
    cold, warm = json.loads(out0), json.loads(out1)
    svc = warm["stats"]["service"]
    print(f"  through the store, each in a fresh process: cold "
          f"{cold_s:.4f} s (computed {cold['stats']['service']['computed']}"
          f"; process {cold_wall:.2f} s), warm {warm_s:.4f} s (disk hits "
          f"{svc['disk_hits']}, computed {svc['computed']}; process "
          f"{warm_wall:.2f} s): warm/cold {warm_s / cold_s:.3f}")
    if (rc0, rc1) != (0, 0) or svc["computed"] or \
            svc["disk_hits"] != len(ANALYZE["models"]) or \
            warm["results"] != cold["results"] or \
            cold["results"] != _normal(want):
        raise SmokeError("analyze through the store: the warm run computed "
                         "or differs from the cold one")
    rc, out, _ = cli_run(cli, ANALYZE_ARGV)
    print("  " + out.rstrip().replace("\n", "\n  "))
    return {"child_s": child_s, "cold_s": cold_s, "warm_s": warm_s,
            "cold_process_s": cold_wall, "warm_process_s": warm_wall}


def sweep_tier(cli, api, store: pathlib.Path) -> dict:
    """8c: the sweep sharded over spawned workers through the store, from
    this process (which holds the card's context), point for point against
    the sequential sweep, then warm from the store; then the same requests
    in fresh processes, as a user of ``python -m repro_torch`` runs them:
    sequential, and pooled cold and warm through a store of their own."""
    n0, n1, step = SWEEP["range"]
    api.clear_sessions()
    t0 = time.perf_counter()
    seq = api.sweep(SWEEP["source"], "H100", "N", range(n0, n1 + 1, step),
                    constants=SWEEP["constants"], compiled=True)
    seq_s = time.perf_counter() - t0
    want = _normal({m: [r.to_dict() for r in rs] for m, rs in seq.items()})
    runs = []
    for _ in range(2):
        api.clear_sessions()
        rc, out, dt = cli_run(cli, SWEEP_ARGV + [
            "--cache-dir", str(store), "--stats", "--json"])
        runs.append((rc, json.loads(out), dt))
    (rc0, cold, cold_s), (rc1, warm, warm_s) = runs
    c_svc, w_svc = cold["stats"]["service"], warm["stats"]["service"]
    print(f"  in this process: sweep over {len(want['ecm'])} points, "
          f"{SWEEP['workers']} spawned workers (each re-running this "
          f"script's imports, torch among them): cold {cold_s:.4f} s "
          f"(computed {c_svc['computed']}, worker batches "
          f"{c_svc['worker_batches']}), warm {warm_s:.4f} s (disk hits "
          f"{w_svc['disk_hits']}, computed {w_svc['computed']}): warm/cold "
          f"{warm_s / cold_s:.3f}; the sequential sweep {seq_s:.4f} s")
    if (rc0, rc1) != (0, 0) or c_svc["worker_batches"] != 1 or \
            cold["results"] != want:
        raise SmokeError("the sharded sweep differs from the sequential one "
                         "or never reached the worker pool")
    if w_svc["computed"] or w_svc["disk_hits"] != w_svc["requests"] or \
            warm["results"] != want:
        raise SmokeError("the warm sweep computed or differs")
    fresh = store.parent / "store_fresh"
    shutil.rmtree(fresh, ignore_errors=True)
    seq_argv = SWEEP_ARGV[:SWEEP_ARGV.index("--workers")] + ["--json"]
    rc, out, fseq_s, fseq_wall = child_cli(seq_argv)
    if rc != 0 or json.loads(out) != want:
        raise SmokeError(f"the sequential sweep in a fresh process (exit "
                         f"{rc}) differs from this process's")
    runs = [child_cli(SWEEP_ARGV + ["--cache-dir", str(fresh), "--stats",
                                    "--json"]) for _ in range(2)]
    (rc0, out0, fcold_s, fcold_wall), (rc1, out1, fwarm_s, fwarm_wall) = runs
    cold, warm = json.loads(out0), json.loads(out1)
    c_svc, w_svc = cold["stats"]["service"], warm["stats"]["service"]
    print(f"  in fresh processes: sequential {fseq_s:.4f} s (process "
          f"{fseq_wall:.2f} s); {SWEEP['workers']} spawned workers cold "
          f"{fcold_s:.4f} s (worker batches {c_svc['worker_batches']}; "
          f"process {fcold_wall:.2f} s), warm {fwarm_s:.4f} s (disk hits "
          f"{w_svc['disk_hits']}, computed {w_svc['computed']}; process "
          f"{fwarm_wall:.2f} s): pool/sequential {fcold_s / fseq_s:.1f}, "
          f"warm/cold {fwarm_s / fcold_s:.3f}")
    if (rc0, rc1) != (0, 0) or c_svc["worker_batches"] != 1 or \
            cold["results"] != want or w_svc["computed"] or \
            w_svc["disk_hits"] != w_svc["requests"] or \
            warm["results"] != want:
        raise SmokeError("the pooled sweep in fresh processes differs, never "
                         "reached the pool, or its warm run computed")
    return {"points": len(want["ecm"]), "cold_s": cold_s, "warm_s": warm_s,
            "sequential_s": seq_s,
            "fresh_process": {"sequential_s": fseq_s, "cold_s": fcold_s,
                              "warm_s": fwarm_s,
                              "sequential_process_s": fseq_wall,
                              "cold_process_s": fcold_wall,
                              "warm_process_s": fwarm_wall}}


def tune_tier(tune_mod, space, stencil, service_mod, store: pathlib.Path,
              counters: dict) -> dict:
    """8d: ``tune stencil3d7pt`` through the store twice on the card (in
    this process, so that its launches are counted), then a predict-only
    request on the CPU in the same directory, which must be a miss."""
    name = "stencil3d7pt"
    fam = stencil.family(name)
    wrapper = getattr(fam.module, name)

    def served(**kw):
        svc = service_mod.AnalysisService(cache_dir=str(store))
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        rep = tune_mod.tune(name, "H100", top_k=TUNE_TOP_K, isolate=False,
                            service=svc, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved = {k: c.launches for k, c in counters.items()}
        return rep, svc.stats, dt, moved

    cold, cs, cold_s, c_moved = served(device="cuda")
    print(f"  cold: {cold_s:.4f} s, computed {cs.computed}, launches "
          f"{c_moved}")
    if cs.computed != 1 or c_moved[name] <= 0 or \
            cold.measured_chosen_s is None:
        raise SmokeError(f"the cold tune computed {cs.computed} reports and "
                         f"launched {c_moved}")
    sp = space.resolve_space(name, "H100")
    n = cold.chosen_params["n"]
    out = sp.runner({"n": n}, "cuda")()
    torch.cuda.synchronize()
    args = stencil.make_inputs(name, sp.shape(n), "cuda")
    err, _ = compare(name, out, fam.module.plain(*args), fam.module.RADIUS)
    print(f"  chosen n={n} ({cold.measured_chosen_s * 1e3:.6f} ms a "
          f"sample), held against plain: max abs err {err:.3e}")
    warm, ws, warm_s, w_moved = served(device="cuda")
    print(f"  warm: {warm_s:.4f} s, disk hits {ws.disk_hits}, computed "
          f"{ws.computed}, launches {w_moved}: warm/cold "
          f"{warm_s / cold_s:.4f}")
    if ws.disk_hits != 1 or ws.computed or any(w_moved.values()) or \
            warm.to_dict() != cold.to_dict():
        raise SmokeError("the warm tune was not one store hit with an equal "
                         "report and no launch")
    _, ps, cpu_s, p_moved = served(device="cpu", measure=False)
    print(f"  --device cpu --no-measure in the same directory: "
          f"{cpu_s:.4f} s, disk hits {ps.disk_hits}, computed "
          f"{ps.computed} (a miss), launches {p_moved}")
    if ps.disk_hits or ps.computed != 1 or any(p_moved.values()):
        raise SmokeError("the CPU request was served from the card's entry")
    wrapper.launches = 0
    return {"cold_s": cold_s, "warm_s": warm_s, "cpu_s": cpu_s,
            "launches": c_moved[name], "chosen": cold.chosen_params,
            "max_abs_err": err}


def analysis_tier(counters: dict) -> dict:
    """Phase 8: 8a lint, 8b analyze, 8c the sharded sweep through the
    store, 8d the stencil tune served from the store on the card."""
    from repro_torch import cli, service as service_mod
    from repro_torch import tune as tune_mod
    from repro_torch.core import api
    from repro_torch.tune import space, stencil
    store = ROOT / "build" / "chip_smoke" / "store"
    shutil.rmtree(store, ignore_errors=True)
    print("  8a lint")
    out = {"lint": lint_tier(cli)}
    print("  8b analyze")
    out["analyze"] = analyze_tier(cli, api, store)
    print("  8c sweep through the store and the worker pool")
    out["sweep"] = sweep_tier(cli, api, store)
    print("  8d tune stencil3d7pt through the store")
    out["tune"] = tune_tier(tune_mod, space, stencil, service_mod, store,
                            counters)
    print(f"  store: {service_mod.ResultStore(store).summary(detail=True)}")
    return out


# ----------------------------------------------------------------------
# phase 9: the LM stack served on the card
# ----------------------------------------------------------------------
def _lm_runs(model, params, batch: dict, steps: int) -> list:
    """The full forward's logits, then the last-position logits of a
    prefill of all but ``steps`` tokens and of ``steps`` decode steps, as
    float32 on the host."""
    from repro_torch.serve import make_caches
    toks = batch["tokens"]
    b, s = toks.shape
    dev = toks.device
    with torch.inference_mode():
        out = [model.forward(params, batch)]
        caches = make_caches(model, b, REDUCED_MAX_LEN, dev)
        lg, caches = model.prefill(
            params, dict(batch, tokens=toks[:, :s - steps]), caches)
        out.append(lg)
        for i in range(s - steps, s):
            lg, caches = model.decode_step(params, caches,
                                           toks[:, i:i + 1], i)
            out.append(lg)
    return [t.float().cpu() for t in out]


@contextlib.contextmanager
def checked_flash(fa):
    """Hold every ``ops.flash_attention`` call made inside the block
    against ``fa.plain`` on its own operands: |kernel - plain| <= FA_TOL
    times max(1, max |v|), since the output is a convex combination of
    v's rows, so an error of the softmax weights moves it in proportion
    to |v| (this init's v reaches 100 and more).  The kernel call is the
    path's own, made once, and counts; plain launches nothing.  Yields a
    dict keyed by (q shape, k shape, causal, q_offset, dtype) of the
    calls, their route and their worst error over its tolerance."""
    from repro_torch.kernels import ops
    real = ops.flash_attention
    seen = {}

    def check(q, k, v, causal=True, q_offset=None):
        out, route = routed(fa, lambda: real(q, k, v, causal=causal,
                                             q_offset=q_offset))
        with torch.no_grad():     # under training, the check records nothing
            want = fa.plain(q, k, v, causal=causal, q_offset=q_offset)
            tol = FA_TOL[q.dtype] * max(1.0, v.float().abs().max().item())
            err = (out.float() - want.float()).abs().max().item()
        key = (tuple(q.shape), tuple(k.shape), causal, q_offset, q.dtype)
        row = seen.setdefault(key, {"calls": 0, "route": route,
                                    "worst": 0.0, "err": 0.0})
        row["calls"] += 1
        if err / tol > row["worst"]:
            row["worst"], row["err"] = err / tol, err
        if out.shape != want.shape or not err <= tol:
            raise SmokeError(f"flash_attention at q {key[0]}, k {key[1]}, "
                             f"q_offset {q_offset}: {err:.3e} from plain on "
                             f"its own operands, over {tol:.3e}")
        return out
    ops.flash_attention = check
    try:
        yield seen
    finally:
        ops.flash_attention = real


def unit_normal_checks(fa, seen: dict, what: str) -> dict:
    """Each distinct flash call of ``seen`` once more on seeded
    unit-normal operands of its shape (the inputs FA_TOL is stated for),
    through the ops wrapper; prints one line for the lot and returns the
    worst error per shape."""
    from repro_torch.kernels import ops
    errs = {}
    for n, ((sq, sk, causal, off, dt), row) in enumerate(seen.items()):
        q, k, v = qkv(sq, sk[2], dt, SEED + n)
        out = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
        errs[(sq, sk, off)] = fa_compare(
            f"{what} at q {sq}, k {sk}", out,
            fa.plain(q, k, v, causal=causal, q_offset=off), dt)
    calls = sum(r["calls"] for r in seen.values())
    worst = max((r["worst"] for r in seen.values()), default=0.0)
    routes = sorted({r["route"] for r in seen.values()})
    print(f"    {what}: {calls} flash calls ({len(seen)} shapes, on "
          f"{routes}) held against plain on their own operands, worst "
          f"{worst:.3f} of the tolerance; on unit-normal operands at "
          f"FA_TOL worst {max(errs.values(), default=0.0):.3e}")
    return {"calls": calls, "shapes": len(seen), "routes": routes,
            "own_worst_of_tol": worst,
            "unit_normal_max_abs_err": max(errs.values(), default=0.0)}


def reduced_on_card(arch: str, fa, configs, common, lm) -> dict:
    """Phase 9a for one reduced config: ``forward``, then prefill and
    REDUCED_STEPS decode steps, on the card in the config's types and on
    the CPU twice, from the same seeded parameters: in the config's types
    and in float32 (the yardstick).  Holds the card to the rule the CPU
    tests hold the port to against JAX (``tests/test_torch_lm.py``): its
    logits no further from the float32 run than BF16_FACTOR times the
    CPU's own bf16 run, plus BF16_SLACK.  Every flash call of the card
    run is held against plain on its own operands and its shape again on
    unit-normal ones (:func:`checked_flash`).  Returns the errors, the
    flash launches on the card and the flash checks."""
    cfg = configs.reduced(configs.get_config(arch))
    model = lm.LM(cfg)
    params = common.materialize(model.param_recs(),
                                torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)
    b, s = REDUCED_SHAPE
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g)}
    if cfg.n_img_tokens:
        batch["patch_embeds"] = torch.randn(b, cfg.n_img_tokens, cfg.d_model,
                                            generator=g)
    if cfg.encdec:
        batch["frames"] = torch.randn(b, cfg.enc_len, cfg.d_model,
                                      generator=g)
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    params32 = common.tmap(lambda t: t.float() if t.is_floating_point()
                           else t, params)
    ref = _lm_runs(lm.LM(cfg32), params32, batch, REDUCED_STEPS)
    cpu = _lm_runs(model, params, batch, REDUCED_STEPS)
    counts = fa.flash_attention.launches_by_route
    for r in counts:
        counts[r] = 0
    on_card = common.tmap(lambda t: t.cuda(), params)
    with checked_flash(fa) as seen:
        card = _lm_runs(model, on_card,
                        {k: v.cuda() for k, v in batch.items()},
                        REDUCED_STEPS)
    torch.cuda.synchronize()
    launches = dict(counts)
    for t, r in zip(card, ref):
        if t.shape != r.shape or not torch.isfinite(t).all():
            raise SmokeError(f"9a {arch}: logits of shape {tuple(t.shape)} "
                             "(or non-finite) on the card, where the CPU "
                             f"gives {tuple(r.shape)}")
    err_card = max((c - r).abs().max().item() for c, r in zip(card, ref))
    err_cpu = max((c - r).abs().max().item() for c, r in zip(cpu, ref))
    err_pair = max((c - r).abs().max().item() for c, r in zip(card, cpu))
    bound = BF16_FACTOR * err_cpu + BF16_SLACK
    print(f"  {arch:26s} {cfg.act_dtype:8s} |card - f32| {err_card:.4f}  "
          f"|cpu - f32| {err_cpu:.4f}  bound {bound:.4f}  |card - cpu| "
          f"{err_pair:.4f}  flash {launches}")
    if err_card > bound:
        raise SmokeError(f"9a {arch}: the card's logits are {err_card:.4f} "
                         f"from the float32 run, over {bound:.4f}")
    flash = unit_normal_checks(fa, seen, f"9a {arch}") if seen else None
    return {"err_card_f32": err_card, "err_cpu_f32": err_cpu,
            "err_card_cpu": err_pair, "bound": bound, "launches": launches,
            "flash": flash}


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_attention" in n:
        return "flash"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "gemv",
                            "splitk")):
        return "gemm"
    return "other"


def device_profile(fn) -> dict:
    """``torch.profiler`` over one call of ``fn``: device microseconds
    and launches per kernel name, and per class (flash, GEMM, other:
    elementwise, reductions, copies).  Kernel events only, so a kernel's
    time is not counted again under the operator that launched it."""
    from torch.profiler import ProfilerActivity, profile as prof
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    kernels, classes = {}, {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    for e in p.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue          # an operator on the host: its kernels count
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev:
            kernels[e.key] = {"device_us": dev, "count": e.count}
            classes[_kernel_class(e.key)] += dev
    return {"kernels": kernels, "classes": classes}


def print_profile(what: str, pr: dict) -> None:
    total = sum(pr["classes"].values())
    print(f"    torch.profiler, {what}: {total / 1e3:.3f} ms of device "
          "time; " + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / max(total, 1):.1%})"
                              for k, v in pr["classes"].items()))
    top = sorted(pr["kernels"].items(), key=lambda kv: -kv[1]["device_us"])
    for name, row in top[:PROFILE_ROWS]:
        print(f"      {row['device_us'] / 1e3:9.3f} ms  x{row['count']:<5d} "
              f"[{_kernel_class(name)}] {name[:90]}")


def bucket_tokens(prompts: list) -> torch.Tensor:
    """A bucket's prompts left-padded with 0 to its longest, on the card,
    as ``BatchedServer`` pads them."""
    s = max(len(p) for p in prompts)
    return torch.tensor([[0] * (s - len(p)) + list(p) for p in prompts],
                        device="cuda")


def serve(cfg, prompts: list) -> dict:
    """Serve ``prompts`` (SERVE['max_new'] new tokens each) with ``cfg``'s
    weights drawn on the card from SEED, behind ``BatchedServer``, after
    one untimed warm-up bucket; the prefill and decode calls are timed
    with CUDA events and their last-position logits kept.  Launch
    counters are zeroed just before the requests are drained and read
    just after."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common
    from repro_torch.models.lm import LM
    from repro_torch.serve import BatchedServer, Engine, Request
    model = LM(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = common.materialize(model.param_recs(),
                                torch.Generator("cuda").manual_seed(SEED),
                                default_dtype=common.dtype_of(cfg.act_dtype))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    engine = Engine(model, params, max_len=SERVE["max_len"])
    events = {"prefill": [], "decode": []}
    logits = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            events[kind].append((start, end))
            logits[kind].append(out[0][:, -1])
            return out
        return call
    engine.prefill = timed("prefill", engine.prefill)
    engine.decode = timed("decode", engine.decode)
    # one untimed bucket first: cuBLAS and the caching allocator set up on
    # their first calls, which would land in the first bucket's times
    engine.generate(torch.zeros(SERVE["batch_size"], 64, dtype=torch.long),
                    2)
    for kind in events:
        events[kind].clear()
        logits[kind].clear()
    server = BatchedServer(engine, batch_size=SERVE["batch_size"])
    for i, p in enumerate(prompts):
        server.submit(Request(uid=i, tokens=p, max_new=SERVE["max_new"]))
    counts = fa.flash_attention.launches_by_route
    for r in counts:
        counts[r] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b = SERVE["batch_size"]
    buckets = [done[i:i + b] for i in range(0, len(done), b)]
    return {"cfg": cfg, "model": model, "params": params, "draw_s": draw_s,
            "done": done, "buckets": buckets, "served": server._served,
            "s_max": [max(len(r.tokens) for r in bk) for bk in buckets],
            "launches": dict(counts), "wall": wall, "logits": logits,
            "prefill_ms": [s.elapsed_time(e) for s, e in events["prefill"]],
            "decode_ms": [s.elapsed_time(e) for s, e in events["decode"]],
            "peak": torch.cuda.max_memory_allocated()}


def report_serve(run: dict, h100, card: str, lengths: list) -> dict:
    """Print 9b's times beside their bounds and check the flash launches:
    at least one per layer per prefill bucket on the dtype's tensor-core
    route.  Bounds, reckoned from the code and ``h100_sxm.yaml``: prefill
    = the larger of its flops (2 per weight per token outside the
    embedding, the head on the last position, 4·hd per causal (query,
    key) pair per head and layer) at the bf16 peak and the weights' bytes
    at the HBM rate; decode = the weights' bytes and the kv cache's bytes
    at the step's mean length at the HBM rate."""
    from repro_torch.models import common
    cfg, model, s_max = run["cfg"], run["model"], run["s_max"]
    n_params = cfg.param_count()
    p_bytes = common.nbytes(run["params"])
    b = SERVE["batch_size"]
    d, L, hd, h = cfg.d_model, cfg.n_layers, cfg.head_dim, cfg.n_heads
    embed = model.padded_vocab * d
    bw, peak_flops = h100.hbm_bandwidth, h100.peak_flops["BF16"]
    n_new = SERVE["max_new"]
    pre_bound = []
    for s in s_max:
        flops = (2 * (n_params - embed) * b * s + 2 * embed * b
                 + L * 4 * hd * h * b * s * (s + 1) // 2)
        pre_bound.append(max(flops / peak_flops, p_bytes / bw) * 1e3)
    kv_row = L * 2 * cfg.n_kv_heads * hd * common.dtype_of(
        cfg.act_dtype).itemsize                # k and v of one token
    mean_len = sum(s + i for s in s_max for i in range(1, n_new)) / (
        len(s_max) * (n_new - 1))
    dec_bound = (p_bytes + b * mean_len * kv_row) / bw * 1e3
    dec_ms = run["decode_ms"]
    med = statistics.median(dec_ms)
    tokens = sum(len(r.result) for r in run["done"])
    print(f"  9b {cfg.name} at its published widths, {L} layers: tp=1 "
          f"(tp=16 pads the 8 kv heads to 16, a shape of the TPU mesh "
          f"only), d {d}, {h} heads of {hd}, {cfg.n_kv_heads} kv heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params / 1e9:.3f} B "
          f"parameters, {p_bytes / 1e9:.3f} GB in {cfg.act_dtype}, drawn on "
          f"the card in {run['draw_s']:.1f} s")
    print(f"    {len(lengths)} requests of {lengths} tokens, {n_new} new "
          f"each, batch {b}, max_len {SERVE['max_len']}: buckets "
          f"{run['served']} padded to {s_max} on {card}")
    for i, (ms, bd, s) in enumerate(zip(run["prefill_ms"], pre_bound,
                                        s_max)):
        print(f"    prefill bucket {i}: {ms:.3f} ms for {b} x {s} tokens; "
              f"bound {bd:.3f} ms ({bd / ms:.1%} of it; "
              f"{(bd / 1e3 * peak_flops) / (b * s) / 1e9:.2f} GFLOP a token "
              f"at {peak_flops / 1e12:.0f} TFLOP/s bf16)")
    print(f"    decode: median {med:.3f} ms a step over {len(dec_ms)} steps "
          f"(min {min(dec_ms):.3f}, max {max(dec_ms):.3f}); bound "
          f"{dec_bound:.3f} ms ({dec_bound / med:.1%} of it: "
          f"{p_bytes / 1e9:.2f} GB of weights, {p_bytes / bw * 1e3:.3f} ms, "
          f"and the kv cache at a mean {mean_len:.0f} tokens, "
          f"{b * mean_len * kv_row / 1e6:.1f} MB, at {bw / 1e12:.2f} TB/s)")
    print(f"    end to end: {tokens} tokens in {run['wall']:.3f} s = "
          f"{tokens / run['wall']:.1f} tokens/s; peak memory allocated "
          f"{run['peak'] / 1e9:.2f} GB")
    route = TC_ROUTE[common.dtype_of(cfg.act_dtype)]
    launches = run["launches"]
    need = len(s_max) * L
    print(f"    flash launches per route: {launches} ({len(s_max)} prefill "
          f"buckets x {L} layers = {need} at least on {route})")
    if launches[route] < need:
        raise SmokeError(f"9b: {launches[route]} {route} launches for "
                         f"{len(s_max)} prefills of {L} layers")
    return {"prefill_ms": run["prefill_ms"], "prefill_bound_ms": pre_bound,
            "decode_ms": dec_ms, "decode_median_ms": med,
            "decode_bound_ms": dec_bound, "tokens_per_s": tokens / run["wall"],
            "wall_s": run["wall"], "peak_bytes": run["peak"],
            "param_bytes": p_bytes, "buckets": s_max, "launches": launches,
            "route": route}


def profile_serve(run: dict) -> tuple:
    """One prefill (bucket 0's padded prompts) and one decode step under
    ``torch.profiler``; returns both profiles."""
    from repro_torch.serve import make_caches
    model, params = run["model"], run["params"]
    toks = bucket_tokens([r.tokens for r in run["buckets"][0]])
    caches = make_caches(model, len(toks), SERVE["max_len"], "cuda")
    state = {}

    def prefill():
        with torch.inference_mode():
            state["out"] = model.prefill(params, {"tokens": toks}, caches)

    def decode():
        lg, c = state["out"]
        with torch.inference_mode():
            model.decode_step(params, c, lg[:, -1].argmax(-1)[:, None],
                              toks.shape[1])
    pre = device_profile(prefill)
    dec = device_profile(decode)
    print_profile(f"one prefill (bucket 0, {tuple(toks.shape)})", pre)
    print_profile("one decode step", dec)
    return pre, dec


def served_flash(run: dict, fa) -> tuple[dict, dict]:
    """9c: each bucket's prefill again, as the server ran it, with every
    flash call held against plain on its own operands and each shape on
    unit-normal ones (:func:`checked_flash`).  Returns the calls seen and
    the checks' numbers."""
    from repro_torch.serve import make_caches
    model, params = run["model"], run["params"]
    with checked_flash(fa) as seen, torch.inference_mode():
        for bk in run["buckets"]:
            toks = bucket_tokens([r.tokens for r in bk])
            model.prefill(params, {"tokens": toks},
                          make_caches(model, len(toks), SERVE["max_len"],
                                      "cuda"))
    torch.cuda.synchronize()
    return seen, unit_normal_checks(
        fa, seen, f"9c both buckets' prefills, {run['cfg'].n_layers} layers")


def flash_at_served_shape(run: dict, seen: dict, fa, measure, space,
                          h100) -> dict:
    """9c: the flash call of the longest served prefill, timed on seeded
    unit-normal operands (the inputs its tolerance is stated for) beside
    plain, SDPA and two bounds: the call's own (kv heads broadcast, rows
    padded to 64), which the kernels line carries, and the model's
    attention (its kv heads, the bucket's real rows).  Returns the
    kernels-line entry (launches filled in by the caller)."""
    from repro_torch.kernels import ops
    sq, sk, _, _, dt = max(seen, key=lambda key: key[0][2])
    q, k, v = qkv(sq, sk[2], dt, SEED)

    def kernel():
        return ops.flash_attention(q, k, v, causal=True, q_offset=0)

    def plain():
        return fa.plain(q, k, v, causal=True, q_offset=0)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    out, route = routed(fa, kernel)
    if route != TC_ROUTE[dt]:
        raise SmokeError(f"9c: the served prefill's flash call ran on {route}")
    name = str(dt)[6:]
    err = fa_compare(f"served prefill shape {name}", out, plain(), dt)
    fa_compare("SDPA yardstick at the served shape", sdpa(), out, dt)
    t_fa = measure.time_cuda(kernel, warmup=2, iters=5, reps=5).wall_s * 1e3
    t_plain = measure.time_cuda(plain, warmup=1, iters=1,
                                reps=3).wall_s * 1e3
    t_sdpa = measure.time_cuda(sdpa, warmup=2, iters=5, reps=5).wall_s * 1e3
    bound = space.attention_bound(q, k, causal=True, q_offset=0,
                                  machine=h100)
    cfg, rows = run["cfg"], max(run["s_max"])
    real = space.attention_bound(
        torch.empty(sq[0], cfg.n_heads, rows, sq[3], dtype=dt, device="meta"),
        torch.empty(sq[0], cfg.n_kv_heads, rows, sq[3], dtype=dt,
                    device="meta"),
        causal=True, q_offset=0, machine=h100)
    print(f"  9c flash at the longest served prefill: q {sq}, k and v {sk} "
          f"{name}, causal, q_offset 0, route {route}: max abs err vs plain "
          f"{err:.3e} on unit-normal operands (tolerance {FA_TOL[dt]})")
    b_ms, r_ms = bound.seconds * 1e3, real.seconds * 1e3
    print(f"    kernel {t_fa:.4f} ms, plain {t_plain:.4f} ms, SDPA "
          f"{t_sdpa:.4f} ms (yardstick only); bound of this call "
          f"{b_ms:.4f} ms by {bound.by} ({b_ms / t_fa:.1%} of the kernel's "
          f"time); bound of the model's attention ({cfg.n_kv_heads} kv "
          f"heads, {rows} real rows) {r_ms:.4f} ms by {real.by} "
          f"({r_ms / t_fa:.1%})")
    return {"name": f"flash_attention[{SERVE_ARCH} serve]", "route": "cuda",
            "source": f"src/repro_torch/csrc/{fa.SOURCES[route]}.cu",
            "replaces": REPLACES["flash_attention"], "launches": 0,
            "max_abs_err": err, "ms": t_fa, "plain_ms": t_plain,
            "bound_ms": bound.seconds * 1e3, "bound_by": bound.by,
            "library_ms": t_sdpa, "shape_q": list(sq), "shape_kv": list(sk),
            "model_bound_ms": real.seconds * 1e3, "model_bound_by": real.by}


def _forward_tail(model, params, toks: torch.Tensor) -> torch.Tensor:
    """The teacher-forced forward over ``toks``: float32 logits at the
    positions that predicted each of its last SERVE['max_new'] tokens."""
    n_new = SERVE["max_new"]
    with torch.inference_mode():
        full = model.forward(params, {"tokens": toks})
    return full[:, -n_new - 1:-1].float()


def greedy_check(run: dict, margin: float | None, what: str) -> dict:
    """9c: each greedy token against the teacher-forced forward's argmax
    on the padded sequences.  A disagreement fails the phase where the
    forward's top-two gap exceeds ``margin`` (None: printed only).
    Prints the agreement share and how far the served logits lie from
    the forward's."""
    agree = total = over = 0
    worst_gap = 0.0
    delta = []
    n_new = SERVE["max_new"]
    for i, bk in enumerate(run["buckets"]):
        seqs = bucket_tokens([r.tokens + r.result for r in bk])
        pred = _forward_tail(run["model"], run["params"], seqs)
        served = torch.stack(
            [run["logits"]["prefill"][i]] + run["logits"]["decode"][
                i * (n_new - 1):(i + 1) * (n_new - 1)], dim=1).float()
        delta.append((served - pred).abs().amax(-1).flatten())
        top2 = pred.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        same = pred.argmax(-1) == torch.tensor([r.result for r in bk],
                                               device="cuda")
        agree += int(same.sum())
        total += same.numel()
        if (~same).any():
            worst_gap = max(worst_gap, gap[~same].max().item())
            if margin is not None:
                over += int(((~same) & (gap > margin)).sum())
    delta = torch.cat(delta)
    print(f"  9c greedy vs the teacher-forced forward, {what}: "
          f"{agree}/{total} tokens agree ({agree / total:.1%}); served "
          f"logits vs the forward's: max {delta.max().item():.4f}, median "
          f"{delta.median().item():.4f}; largest top-two gap at a "
          f"disagreement {worst_gap:.4f}, "
          + ("printed only" if margin is None else f"margin {margin:.4f}"))
    if over:
        raise SmokeError(f"9c {what}: {over} greedy tokens disagree with the "
                         f"forward where its top-two gap exceeds {margin}")
    return {"agree": agree / total, "delta_max": delta.max().item(),
            "delta_median": delta.median().item(), "worst_gap": worst_gap,
            "margin": margin}


def serve_case() -> tuple:
    """granite-8b at its published widths (tp=1) and SERVE's prompts,
    drawn from SEED."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_config(SERVE_ARCH), tp=1)
    g = torch.Generator().manual_seed(SEED)
    lo, hi = SERVE["prompt"]
    lengths = torch.randint(lo, hi + 1, (SERVE["requests"],),
                            generator=g).tolist()
    return cfg, [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
                 for n in lengths]


def serve_granite(fa, measure, space, h100, card: str) -> tuple:
    """Phases 9b and 9c: granite-8b at its published widths and full depth
    (tp=1) behind ``BatchedServer``, its profile, every served prefill's
    flash calls held against plain, the call at the longest served shape
    timed, and the greedy agreement printed; then the same widths cut to
    each depth of GREEDY_CUTS and GREEDY_PAST, served again with every
    flash call held, and their greedy agreement printed, gated at
    GREEDY_MARGIN for GREEDY_CUTS.  Returns the kernels-line entry and
    the numbers for ``--out``."""
    cfg, prompts = serve_case()
    lengths = [len(p) for p in prompts]
    run = serve(cfg, prompts)
    numbers = report_serve(run, h100, card, lengths)
    pre, dec = profile_serve(run)
    numbers["profile"] = {"prefill": pre["classes"], "decode": dec["classes"]}
    seen, numbers["flash_checks"] = served_flash(run, fa)
    entry = flash_at_served_shape(run, seen, fa, measure, space, h100)
    entry["launches"] = run["launches"][numbers["route"]]
    numbers["greedy"] = greedy_check(run, None, f"{cfg.n_layers} layers")
    del run, seen
    torch.cuda.empty_cache()
    for dtype, depth in sorted(GREEDY_CUTS + GREEDY_PAST):
        cut = dataclasses.replace(cfg, n_layers=depth, act_dtype=dtype)
        what = f"the same widths cut to {depth} layer(s) in {dtype}"
        with checked_flash(fa) as seen:
            run = serve(cut, prompts)
        route = TC_ROUTE[getattr(torch, dtype)]
        if run["launches"][route] < len(run["s_max"]) * depth:
            raise SmokeError(f"9c {what}: {run['launches']} flash launches")
        numbers[f"flash_checks_{dtype}_{depth}"] = unit_normal_checks(
            fa, seen, f"9c {what}")
        gated = (dtype, depth) in GREEDY_CUTS
        numbers[f"greedy_{dtype}_{depth}"] = greedy_check(
            run, GREEDY_MARGIN if gated else None,
            f"{what}, served again ({run['launches']} flash launches)")
        del run
        torch.cuda.empty_cache()
    return entry, numbers


# ----------------------------------------------------------------------
# phase 10: training on the card
# ----------------------------------------------------------------------
@contextlib.contextmanager
def checked_backward(fa):
    """Hold every backward of ``FlashAttentionFn`` made inside the block
    (``fa.flash_attention_backward``, on either route) against autograd
    through ``fa.plain`` on its own operands (q, k, v and the output's
    gradient), BACKWARD_HEADS heads at a time (plain's float32 scores at
    granite's shape are 2.1 GB for all 32): each of dQ, dK and dV within
    FA_TOL times its largest entry.  The backward's own result is what
    the step uses.  Yields a dict keyed by (q shape, k shape, q_offset,
    dtype) of the calls and their worst error over its tolerance."""
    real = fa.flash_attention_backward
    seen = {}

    def check(q, k, v, grad_out, causal=True, q_offset=None):
        got = real(q, k, v, grad_out, causal=causal, q_offset=q_offset)
        want = [torch.empty_like(t) for t in (q, k, v)]
        with torch.enable_grad():
            for i in range(0, q.shape[1], BACKWARD_HEADS):
                cut = [t[:, i:i + BACKWARD_HEADS].detach().requires_grad_()
                       for t in (q, k, v)]
                o = fa.plain(*cut, causal=causal, q_offset=q_offset)
                for w, g in zip(want, torch.autograd.grad(
                        o, cut, grad_out[:, i:i + BACKWARD_HEADS])):
                    w[:, i:i + BACKWARD_HEADS] = g
        tol = FA_TOL[q.dtype]
        rel = []
        for name, g, w in zip("qkv", got, want):
            top = w.float().abs().max().item()
            err = (g.float() - w.float()).abs().max().item()
            rel.append(err / max(top, 1e-30))
            if not (err <= tol * top) or not torch.isfinite(g).all():
                raise SmokeError(
                    f"flash backward d{name} at q {tuple(q.shape)}, k "
                    f"{tuple(k.shape)}, q_offset {q_offset}: {err:.3e} from "
                    f"autograd through plain, over {tol} x {top:.3e}")
        key = (tuple(q.shape), tuple(k.shape), q_offset, q.dtype)
        row = seen.setdefault(key, {"calls": 0, "worst": 0.0})
        row["calls"] += 1
        row["worst"] = max(row["worst"], max(rel) / tol)
        return got
    fa.flash_attention_backward = check
    try:
        yield seen
    finally:
        fa.flash_attention_backward = real


def zero_backward(fa) -> None:
    """Set the backward's counters (each route's and their sum) to 0."""
    for r in fa.flash_attention.backward_calls_by_route:
        fa.flash_attention.backward_calls_by_route[r] = 0
    fa.flash_attention.backward_calls = 0


def _backward_summary(seen: dict) -> dict:
    calls = sum(r["calls"] for r in seen.values())
    worst = max((r["worst"] for r in seen.values()), default=0.0)
    return {"calls": calls, "shapes": len(seen), "worst_of_tol": worst}


def _causal(cfg, lm) -> bool:
    return any(blk.kind in ("attn", "shared_attn")
               for st in lm.build_stages(cfg) for blk in st.blocks)


def _train_case(arch: str, configs, common, lm) -> tuple:
    """10a's config, model, seeded bf16 parameters on the host and a
    batch: tokens, labels (the tokens rolled by one) and the extras 9a
    passes (patch embeddings, frames)."""
    cfg = configs.reduced(configs.get_config(arch))
    model = lm.LM(cfg)
    params = common.materialize(model.param_recs(),
                                torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)
    b, s = TRAIN_REDUCED["batch"], TRAIN_REDUCED["seq"]
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if cfg.n_img_tokens:
        batch["patch_embeds"] = torch.randn(b, cfg.n_img_tokens, cfg.d_model,
                                            generator=g)
    if cfg.encdec:
        batch["frames"] = torch.randn(b, cfg.enc_len, cfg.d_model,
                                      generator=g)
    return cfg, model, params, batch


def _one_step(train, optim, common, model, params, batch, device) -> dict:
    """One ``make_train_step`` step on ``device`` from copies of
    ``params`` and a fresh state; returns its metrics, the first moment's
    leaves (after one step, (1 - b1) times the clipped gradient) and the
    new parameters, on the host in float32."""
    tcfg = train.TrainConfig(opt=optim.OptConfig(lr=TRAIN_REDUCED["lr"]),
                             microbatches=TRAIN_REDUCED["microbatches"],
                             warmup_steps=1, total_steps=10)
    p = common.tmap(lambda t: t.to(device, copy=True), params)
    opt = optim.adamw_init(p, tcfg.opt)
    b = {k: v.to(device) for k, v in batch.items()}
    p, opt, m = train.make_train_step(model, tcfg)(p, opt, b, 1)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "m": [t.float().cpu() for t in common.leaves(opt["m"])],
            "params": [t.float().cpu() for t in common.leaves(p)]}


def _step_error(run: dict, ref: dict) -> float:
    """The largest relative distance of a step from the float32 one: each
    metric against its value, each leaf of the first moment against its
    largest entry."""
    errs = [abs(v - ref["metrics"][k]) / max(abs(ref["metrics"][k]), 1e-30)
            for k, v in run["metrics"].items()]
    for a, r in zip(run["m"], ref["m"]):
        top = r.abs().max().item()
        d = (a - r).abs().max().item()
        errs.append(d / top if top > 0 else (0.0 if d == 0 else math.inf))
    return max(errs)


def reduced_train_on_card(arch: str, fa, configs, common, lm, train,
                          optim) -> dict:
    """Phase 10a for one reduced config: one train step (TRAIN_REDUCED:
    two microbatches, remat on) from the same seeded parameters, state
    and batch, four times: in float32 on the CPU (the reference) and on
    the card, which must lie within TRAIN_TOL of it
    (:func:`_step_error`: the metrics, and the first moment, which
    carries the gradient), and in the config's own types on both, whose
    distance from the float32 step is printed.  Every flash call of both
    card steps (forward and remat's re-forward) is held against plain on
    its own operands and every backward against autograd through plain;
    in a config with causal attention both steps must reach the kernel
    and its backward."""
    cfg, model, params, batch = _train_case(arch, configs, common, lm)
    model32 = lm.LM(dataclasses.replace(cfg, act_dtype="float32"))
    params32 = common.tmap(lambda t: t.float(), params)
    ref = _one_step(train, optim, common, model32, params32, batch, "cpu")
    cpu = _one_step(train, optim, common, model, params, batch, "cpu")
    counts = fa.flash_attention.launches_by_route
    card, launches, backward_calls = {}, {}, {}
    with checked_flash(fa) as seen, checked_backward(fa) as back:
        for name, m, p in (("f32", model32, params32),
                           ("own", model, params)):
            for r in counts:
                counts[r] = 0
            zero_backward(fa)
            card[name] = _one_step(train, optim, common, m, p, batch,
                                   "cuda")
            torch.cuda.synchronize()
            launches[name] = dict(counts)
            backward_calls[name] = dict(
                fa.flash_attention.backward_calls_by_route)
    for run in card.values():
        if not all(math.isfinite(v) for v in run["metrics"].values()) or \
                not all(torch.isfinite(t).all() for t in run["params"]):
            raise SmokeError(f"10a {arch}: a non-finite metric or parameter "
                             "after the card's step")
    err = _step_error(card["f32"], ref)
    e_card, e_cpu = _step_error(card["own"], ref), _step_error(cpu, ref)
    print(f"  {arch:26s} f32 step: card from cpu {err:.3e} (bound "
          f"{TRAIN_TOL}), loss {card['f32']['metrics']['loss']:.4f} (cpu "
          f"{ref['metrics']['loss']:.4f}); {cfg.act_dtype} step from f32: "
          f"card {e_card:.4f}, cpu {e_cpu:.4f}; flash {launches}, backward "
          f"{backward_calls}")
    if not err <= TRAIN_TOL:
        raise SmokeError(f"10a {arch}: the card's float32 step is {err:.3e} "
                         f"from the CPU's, over {TRAIN_TOL}")
    if _causal(cfg, lm) and not all(
            sum(launches[n].values()) > 0
            and sum(backward_calls[n].values()) > 0 for n in card):
        raise SmokeError(f"10a {arch}: causal attention never reached the "
                         "flash kernel or its backward under training")
    flash = unit_normal_checks(fa, seen, f"10a {arch}") if seen else None
    return {"loss": card["f32"]["metrics"]["loss"], "err_f32": err,
            "err_own_card_f32": e_card, "err_own_cpu_f32": e_cpu,
            "launches": launches, "backward_calls": backward_calls,
            "flash": flash, "backward": _backward_summary(back)}


def train_cfg(configs, layers: int):
    """granite-8b at its published widths (tp=1: the 8 kv heads stay 8),
    its depth cut to ``layers``."""
    return dataclasses.replace(configs.get_config(TRAIN_ARCH), tp=1,
                               n_layers=layers)


def train_bound(cfg, model, h100) -> dict:
    """10b's bound, reckoned from the shapes and ``h100_sxm.yaml``: flops
    at the bf16 peak — 2 per weight per token for the forward (the tied
    head counted once, as a product; the embedding lookup is none), 2
    more for remat's re-forward of the layers (the head is not re-run), 4
    for the backward, and 4·hd per causal (query, key) pair per head and
    layer for each attention pass (forward, re-forward, and the backward's
    two and a half: S recomputed, dP, dV, dQ, dK) — and beside it the
    bytes of one AdamW pass at the HBM rate:
    each parameter's float32 gradient, master, m and v read, and its
    master, m, v and bf16 parameter written."""
    n = cfg.param_count()
    embed = model.padded_vocab * cfg.d_model
    tokens = TRAIN["batch"] * TRAIN["seq"]
    s = TRAIN["seq"]
    weights = (2 * n + 2 * (n - embed) + 4 * n) * tokens
    pairs = TRAIN["batch"] * s * (s + 1) // 2
    attention = 18 * cfg.head_dim * cfg.n_heads * cfg.n_layers * pairs
    flops = weights + attention
    adam_bytes = (4 * 4 + 3 * 4 + 2) * n
    return {"flops": flops, "weight_flops": weights,
            "attention_flops": attention,
            "ms": flops / h100.peak_flops["BF16"] * 1e3,
            "adamw_bytes": adam_bytes,
            "adamw_ms": adam_bytes / h100.hbm_bandwidth * 1e3,
            "params": n, "tokens": tokens}


def _timed_steps(trainer, fa):
    """Wrap ``trainer.step_fn``: CUDA events around each call, the flash
    launches and backward calls each makes, and the first call run inside
    the flash and backward checks."""
    real = trainer.step_fn
    rec = {"events": [], "launches": [], "backward": [], "checks": None}

    def step_fn(params, opt, batch, step):
        counts = fa.flash_attention.launches_by_route
        back = fa.flash_attention.backward_calls_by_route
        n0, b0 = dict(counts), dict(back)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if rec["checks"] is None:
            with _first_step_checks(fa) as checks:
                start.record()
                out = real(params, opt, batch, step)
                end.record()
            rec["checks"] = checks
        else:
            start.record()
            out = real(params, opt, batch, step)
            end.record()
        rec["events"].append((start, end))
        rec["launches"].append({r: counts[r] - n0[r] for r in counts})
        rec["backward"].append({r: back[r] - b0[r] for r in back})
        return out
    trainer.step_fn = step_fn
    return rec


@contextlib.contextmanager
def _first_step_checks(fa):
    with checked_flash(fa) as seen, checked_backward(fa) as back:
        yield {"flash": seen, "backward": back}


#: the ranges 10b's profile puts around the attention backward and the
#: optimizer, and the class of the kernels inside each
TRAIN_RANGES = {"flash_attention_backward": "attention backward",
                "adamw_update": "optimizer"}


def _is_cuda(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def train_profile(fn, fa, step_mod) -> dict:
    """``torch.profiler`` over one call of ``fn`` (a train step), with
    ``flash_attention_backward`` and ``adamw_update`` inside
    ``record_function`` ranges of their names: device microseconds per
    class — GEMM, flash forward, attention backward (all the Function's
    backward's kernels), elementwise, optimizer — and the step's host
    seconds.  A kernel belongs to a range when it starts within the
    range's span on the card's timeline (the profiler's GPU user
    annotation); the others are classed by name."""
    from torch.profiler import ProfilerActivity, profile as prof
    from torch.profiler import record_function
    real_bwd, real_upd = fa.flash_attention_backward, step_mod.adamw_update

    def bwd(*a, **kw):
        with record_function("flash_attention_backward"):
            return real_bwd(*a, **kw)

    def upd(*a, **kw):
        with record_function("adamw_update"):
            return real_upd(*a, **kw)
    fa.flash_attention_backward, step_mod.adamw_update = bwd, upd
    try:
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    finally:
        fa.flash_attention_backward, step_mod.adamw_update = \
            real_bwd, real_upd
    events = [e for e in p.events() if _is_cuda(e)]
    spans = sorted((e.time_range.start, e.time_range.end,
                    TRAIN_RANGES[e.name]) for e in events
                   if e.is_user_annotation and e.name in TRAIN_RANGES)
    counted = {v: sum(1 for *_, c in spans if c == v)
               for v in TRAIN_RANGES.values()}
    if not all(counted.values()):
        raise SmokeError(f"10b profile: GPU annotation spans {counted}: the "
                         "profiler did not put the ranges on the card's "
                         "timeline")
    classes = {c: 0.0 for c in ("GEMM", "flash forward",
                                "attention backward", "elementwise",
                                "optimizer")}
    kernels: dict = {}
    for e in events:
        if e.is_user_annotation:
            continue
        t0_us = e.time_range.start
        cls = next((c for a, b, c in spans if a <= t0_us < b), None) or {
            "flash": "flash forward", "gemm": "GEMM",
            "other": "elementwise"}[_kernel_class(e.name)]
        dur = e.time_range.end - t0_us
        classes[cls] += dur
        row = kernels.setdefault(e.name, {"device_us": 0.0, "count": 0,
                                          "class": cls})
        row["device_us"] += dur
        row["count"] += 1
    return {"classes": classes, "kernels": kernels, "host_s": host_s,
            "spans": counted}


def drop_check(fa, configs, common, lm, train) -> dict:
    """10b's check that would catch a dropped gradient: granite-8b's
    widths cut to DROP's one layer and 256 tokens, the loss's gradient in
    float32 on the card (the bf16x3 flash kernel under its Function)
    held per leaf against the same in float32 on the CPU with the flash
    call replaced by autograd through plain, from the same seeded
    parameters and batch: within DROP_TOL of the CPU leaf's largest
    entry, and wq, wk and wv's gradients non-zero.  The card's bf16
    gradient (wgmma) lies within BF16_DROP_TOL of the card's float32
    one."""
    from repro_torch.ckpt.store import flatten
    from repro_torch.kernels import ops
    cfg = train_cfg(configs, DROP["layers"])
    model = lm.LM(cfg)
    model32 = lm.LM(dataclasses.replace(cfg, act_dtype="float32"))
    params = common.materialize(model.param_recs(),
                                torch.Generator("cuda").manual_seed(SEED))
    params32 = common.tmap(lambda t: t.float(), params)
    g = torch.Generator("cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (DROP["batch"], DROP["seq"]),
                         generator=g, device="cuda")
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    counts = fa.flash_attention.launches_by_route

    def grads(m, p, b):
        for r in counts:
            counts[r] = 0
        zero_backward(fa)
        live = common.tmap(lambda t: t.detach().requires_grad_(), p)
        loss, _ = train.loss_fn(m, live, b)
        loss.backward()
        return (flatten(common.tmap(lambda t: t.grad, live)), loss.item(),
                dict(counts), fa.flash_attention.backward_calls)
    g32, l32, n32, b32 = grads(model32, params32, batch)
    g16, l16, n16, b16 = grads(model, params, batch)
    if not (n32["bf16x3"] > 0 and n16["wgmma"] > 0 and b32 > 0 and b16 > 0):
        raise SmokeError(f"10b drop check: the flash kernel or its backward "
                         f"was not reached (float32 {n32}, {b32} backwards; "
                         f"bf16 {n16}, {b16} backwards)")
    real = ops.flash_attention
    ops.flash_attention = (lambda q, k, v, causal=True, q_offset=None:
                           fa.plain(q, k, v, causal=causal,
                                    q_offset=q_offset))
    try:
        ref, lref, _, _ = grads(
            model32, common.tmap(lambda t: t.cpu(), params32),
            {k: v.cpu() for k, v in batch.items()})
    finally:
        ops.flash_attention = real
    rows = {}
    for key, want in ref.items():
        got, own = g32[key], g16[key]
        if got is None or want is None or own is None:
            raise SmokeError(f"10b drop check: {key} has no gradient")
        got = got.cpu()
        top = want.abs().max().item()
        rows[key] = {
            "err": (got - want).abs().max().item() / max(top, 1e-30),
            "max": got.abs().max().item(),
            "bf16": ((own.float().cpu() - got).abs().max().item()
                     / max(got.abs().max().item(), 1e-30))}
    worst = max(rows, key=lambda k: rows[k]["err"])
    print(f"  10b drop check at {DROP['layers']} layer, {DROP['seq']} tokens,"
          f" published widths: loss card f32 {l32:.4f}, cpu f32 {lref:.4f}, "
          f"card bf16 {l16:.4f}; per leaf |g_card - g_cpu| / max |g_cpu| in "
          f"float32: worst {rows[worst]['err']:.3e} ({worst}), bound "
          f"{DROP_TOL}; bf16 from f32 on the card: worst "
          f"{max(r['bf16'] for r in rows.values()):.4f}, bound "
          f"{BF16_DROP_TOL}")
    for key in sorted(rows):
        if any(w in key for w in ("wq", "wk", "wv")):
            print(f"    {key}: {rows[key]['err']:.3e}, max |g| "
                  f"{rows[key]['max']:.3e}; bf16 {rows[key]['bf16']:.4f}")
            if not rows[key]["max"] > 0:
                raise SmokeError(f"10b drop check: {key}'s gradient is zero")
    if not rows[worst]["err"] <= DROP_TOL:
        raise SmokeError(f"10b drop check: {worst}'s float32 gradient on the "
                         f"card is {rows[worst]['err']:.3e} of its largest "
                         f"CPU entry from the CPU's, over {DROP_TOL}")
    bf16_worst = max(rows, key=lambda k: rows[k]["bf16"])
    if not rows[bf16_worst]["bf16"] <= BF16_DROP_TOL:
        raise SmokeError(f"10b drop check: {bf16_worst}'s bf16 gradient on "
                         f"the card is {rows[bf16_worst]['bf16']:.4f} of its "
                         f"largest float32 entry from the float32 one, over "
                         f"{BF16_DROP_TOL}")
    return {"worst": rows[worst]["err"], "worst_leaf": worst,
            "loss_f32": l32, "loss_cpu_f32": lref, "loss_bf16": l16,
            "bf16_worst": rows[bf16_worst]["bf16"],
            "qkv": {k: v for k, v in rows.items()
                    if any(w in k for w in ("wq", "wk", "wv"))}}


def settled_memory() -> int:
    """Free what earlier phases left to the garbage collector, reset the
    peak counter, and return the bytes still allocated: a training run's
    peak counts them too."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def train_flash_timing(cfg, fa, space, measure, h100,
                       what: str = "10b flash at the training shape",
                       mesh=None, rule=None) -> tuple:
    """The flash call of 10b's training, (1, 32, 4096, 128) bf16 causal,
    on seeded unit-normal operands: the kernel, plain, SDPA and the bound
    (the kernels line's numbers); unsharded, also the backward kernel
    (:func:`backward_times`) beside ``attention_backward``, SDPA's forward
    plus backward (the yardstick) and its bound.  With ``mesh`` and
    ``rule`` the call is the sharded path's: ``attention._flash_shards``
    on DTensor operands in the model's (b, s, h, d) layout, placed as
    ``rule`` places q (``local_map``, the copies to heads-first and the
    kernel); the kernel alone is timed beside it (``kernel_ms``).  Returns
    the flash call's kernels-line entry and the backward's (None with
    ``mesh``)."""
    from repro_torch.kernels import ops
    shape = (1, cfg.n_heads, TRAIN["seq"], cfg.head_dim)
    q, k, v = qkv(shape, TRAIN["seq"], torch.bfloat16, SEED)
    do = qkv(shape, TRAIN["seq"], torch.bfloat16, SEED + 1)[0]

    def bare():
        return ops.flash_attention(q, k, v, causal=True, q_offset=0)
    kernel = bare
    if mesh is not None:
        from repro_torch.models import attention, common
        place = common.placements(common.resolve(
            rule, ("batch", None, "act_heads", None)), mesh)
        dq, dk, dv = (common.distribute(t.transpose(1, 2).contiguous(),
                                        mesh, place) for t in (q, k, v))

        def kernel():
            return attention._flash_shards(dq, dk, dv, 0, rule) \
                .to_local().transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    out, route = routed(fa, kernel)
    if route != "wgmma":
        raise SmokeError(f"10b: the training flash call ran on {route}")
    err = fa_compare("10b training shape", out, fa.plain(q, k, v,
                                                         q_offset=0),
                     torch.bfloat16)
    t_fa = measure.time_cuda(kernel, warmup=2, iters=5, reps=5).wall_s * 1e3
    t_bare = t_fa if mesh is None else measure.time_cuda(
        bare, warmup=2, iters=5, reps=5).wall_s * 1e3
    t_plain = measure.time_cuda(lambda: fa.plain(q, k, v, q_offset=0),
                                warmup=1, iters=1, reps=3).wall_s * 1e3
    t_sdpa = measure.time_cuda(sdpa, warmup=2, iters=5, reps=5).wall_s * 1e3
    bound = space.attention_bound(q, k, causal=True, q_offset=0,
                                  machine=h100)
    b_ms = bound.seconds * 1e3
    how = "kernel" if mesh is None else \
        f"through _flash_shards on DTensors (kernel alone {t_bare:.4f} ms)"
    print(f"  {what} {shape} bf16 causal, route "
          f"{route}: {how} {t_fa:.4f} ms ({b_ms / t_fa:.1%} of its bound "
          f"{b_ms:.4f} ms by {bound.by}), plain {t_plain:.4f} ms, SDPA "
          f"{t_sdpa:.4f} ms; max abs err vs plain {err:.3e}")
    entry = {"name": f"flash_attention[{TRAIN_ARCH} train]", "route": "cuda",
             "source": f"src/repro_torch/csrc/{fa.SOURCES[route]}.cu",
             "replaces": REPLACES["flash_attention"], "launches": 0,
             "max_abs_err": err, "ms": t_fa, "plain_ms": t_plain,
             "bound_ms": b_ms, "bound_by": bound.by, "library_ms": t_sdpa,
             "shape_q": list(shape), "kernel_ms": t_bare}
    if mesh is not None:
        return entry, None
    bt = backward_times(fa, space, measure, h100, q, k, v, do)
    print(f"    the backward kernel at the same shape {bt['ms']:.4f} ms "
          f"({bt['bound_ms'] / bt['ms']:.1%} of its bound "
          f"{bt['bound_ms']:.4f} ms by {bt['bound_by']}: two and a half "
          f"attention passes), attention_backward (its plain version, "
          f"float32 scores) {bt['plain_ms']:.4f} ms, SDPA forward + "
          f"backward {bt['library_ms']:.4f} ms, SDPA backward alone "
          f"{bt['library_backward_ms']:.4f} ms (yardsticks only)")
    back = {"name": f"flash_attention_backward[{TRAIN_ARCH} train]",
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{fa.BACKWARD_SOURCE}.cu",
            "replaces": REPLACES["flash_attention"], "launches": 0,
            "max_abs_err": 0.0, "shape_q": list(shape),
            "library_call": "scaled_dot_product_attention forward + "
                            "backward", **bt}
    return entry, back


def train_granite(fa, measure, space, h100, card: str) -> tuple:
    """Phase 10b: granite-8b at its published widths, depth cut to
    TRAIN['layers'], trained by ``Trainer`` on the card (bf16 params,
    ``TrainConfig`` defaults: remat, AdamW with fp32 master, m and v; 4
    microbatches of 1 x 4096 tokens; weights from ``torch.Generator``
    seed SEED, ``SyntheticLM`` seed SEED) for one warm-up step and
    TRAIN['timed'] timed ones.  The first step's flash calls and
    backwards are held against plain; every step's flash launches are
    counted (the counters zeroed just before ``Trainer.run``).  Then one
    more step under ``torch.profiler``, the drop check, and the flash
    call's and the backward kernel's times.  Returns the kernels-line
    entries of both and the numbers."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import common, lm
    from repro_torch import train
    from repro_torch.train import step as step_mod
    cfg = train_cfg(configs, TRAIN["layers"])
    model = lm.LM(cfg)
    bound = train_bound(cfg, model, h100)
    data = SyntheticLM(vocab=cfg.vocab, seq=TRAIN["seq"],
                       global_batch=TRAIN["batch"], seed=SEED)
    tcfg = train.TrainConfig(microbatches=TRAIN["microbatches"])
    trainer = train.Trainer(model, data, tcfg)
    rec = _timed_steps(trainer, fa)
    n_steps = TRAIN["warmup"] + TRAIN["timed"]
    held = settled_memory()
    counts = fa.flash_attention.launches_by_route
    for r in counts:
        counts[r] = 0
    zero_backward(fa)
    t0 = time.perf_counter()
    params, opt, step = trainer.run(
        n_steps, generator=torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(counts)
    backward_calls = dict(fa.flash_attention.backward_calls_by_route)
    peak = torch.cuda.max_memory_allocated()
    log = [m for m in trainer.metrics_log if "loss" in m]
    restarts = [m for m in trainer.metrics_log if m.get("event")]
    ms = [s.elapsed_time(e) for s, e in rec["events"]]
    timed = ms[TRAIN["warmup"]:]
    med = statistics.median(timed)
    per_step = 2 * cfg.n_layers * TRAIN["microbatches"]
    print(f"  10b {cfg.name} at its published widths, depth cut to "
          f"{cfg.n_layers} of 36: tp=1, d {cfg.d_model}, {cfg.n_heads} heads "
          f"of {cfg.head_dim}, {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}; {bound['params']:,} parameters, bf16, "
          f"remat, AdamW (fp32 master, m, v); {TRAIN['microbatches']} "
          f"microbatches of 1 x {TRAIN['seq']} tokens on {card}")
    for m, t, n, b in zip(log, ms, rec["launches"], rec["backward"]):
        print(f"    step {m['step']}: {t:.1f} ms (CUDA events; host "
              f"{m['dt'] * 1e3:.1f} ms), loss {m['loss']:.4f}, grad_norm "
              f"{m['grad_norm']:.4f}, lr {m['lr']:.3e}; flash launches "
              f"{n}, backwards {b}")
    tps = bound["tokens"] / (med / 1e3)
    print(f"    timed steps: median {med:.1f} ms (min {min(timed):.1f}, max "
          f"{max(timed):.1f}) = {tps:,.0f} tokens/s; bound "
          f"{bound['ms']:.1f} ms by operations ({bound['flops'] / 1e12:.1f} "
          f"TFLOP: weights {bound['weight_flops'] / 1e12:.1f}, attention "
          f"{bound['attention_flops'] / 1e12:.1f}, at "
          f"{h100.peak_flops['BF16'] / 1e12:.0f} TFLOP/s), "
          f"{bound['ms'] / med:.1%} of the step; one AdamW pass "
          f"{bound['adamw_bytes'] / 1e9:.1f} GB at "
          f"{h100.hbm_bandwidth / 1e12:.2f} TB/s = {bound['adamw_ms']:.2f} "
          f"ms beside it")
    print(f"    peak memory allocated {peak / 1e9:.2f} GB ({held / 1e9:.2f} "
          f"GB of it held before the run); {len(restarts)} restarts; wall "
          f"{wall:.1f} s for {n_steps} steps; flash launches {launches}, "
          f"backwards {backward_calls}")
    if step != n_steps or restarts:
        raise SmokeError(f"10b: {len(restarts)} restarts, ended at step "
                         f"{step}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in log):
        raise SmokeError("10b: a non-finite loss or grad norm")
    bad = [n for n in rec["launches"] if n["wgmma"] != per_step
           or sum(n.values()) != per_step]
    if bad or any(b != {"kernel": per_step // 2, "plain": 0}
                  for b in rec["backward"]):
        raise SmokeError(f"10b: flash launches a step {rec['launches']} and "
                         f"backwards {rec['backward']}, where each step "
                         f"takes {per_step} wgmma launches and "
                         f"{per_step // 2} kernel backwards, none plain")
    checks = rec["checks"]
    flash = unit_normal_checks(fa, checks["flash"], "10b first step")
    back = _backward_summary(checks["backward"])
    print(f"    10b first step: {back['calls']} backwards held against "
          f"autograd through plain, worst {back['worst_of_tol']:.3f} of the "
          "tolerance")
    batch = trainer._batch(step)
    pr = train_profile(lambda: trainer.step_fn(params, opt, batch, step),
                       fa, step_mod)
    total = sum(pr["classes"].values())
    print(f"    torch.profiler, one step: {total / 1e3:.1f} ms of device time"
          f" ({pr['host_s'] * 1e3:.1f} ms on the host clock; ranges on the "
          f"card's timeline {pr['spans']}); "
          + ", ".join(f"{k} {v / 1e3:.1f} ms ({v / max(total, 1):.1%})"
                      for k, v in pr["classes"].items()))
    top = sorted(pr["kernels"].items(), key=lambda kv: -kv[1]["device_us"])
    for name, row in top[:PROFILE_ROWS]:
        print(f"      {row['device_us'] / 1e3:9.3f} ms  x{row['count']:<5d} "
              f"[{row['class']}] {name[:90]}")
    del params, opt, trainer, batch
    torch.cuda.empty_cache()
    drop = drop_check(fa, configs, common, lm, train)
    torch.cuda.empty_cache()
    entry, back_entry = train_flash_timing(cfg, fa, space, measure, h100)
    entry["launches"] = launches["wgmma"]
    entry["backward_calls"] = backward_calls
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               flash["unit_normal_max_abs_err"])
    back_entry["launches"] = backward_calls["kernel"]
    back_entry["first_step_worst_of_tol"] = back["worst_of_tol"]
    numbers = {"step_ms": ms, "median_ms": med, "tokens_per_s": tps,
               "peak_bytes": peak, "held_bytes": held, "bound": bound,
               "losses": [m["loss"] for m in log],
               "grad_norms": [m["grad_norm"] for m in log],
               "lrs": [m["lr"] for m in log],
               "launches_per_step": rec["launches"],
               "backwards_per_step": rec["backward"],
               "flash_checks": flash, "backward_checks": back,
               "profile": {"classes": pr["classes"],
                           "host_s": pr["host_s"]},
               "drop_check": drop}
    return entry, back_entry, numbers


# ----------------------------------------------------------------------
# phase 13: distribution on the card (world size 1, NCCL)
# ----------------------------------------------------------------------

@contextlib.contextmanager
def nccl_world_one():
    """A process group of one rank on NCCL, over a file store the script
    makes under ``build/``; destroyed on the way out."""
    import torch.distributed as dist
    path = ROOT / "build" / "chip_smoke" / "nccl_store"
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(path), 1),
                            rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()
        if path.exists():
            path.unlink()


def compressed_on_card(dist_mod, mesh, measure) -> dict:
    """13a: ``compressed_psum_tree`` over the mesh's `data` group on a
    granite-sized gradient leaf: at one rank the mean is the local
    dequantised value bit for bit and the residual ``x - deq``; over
    COMPRESS['repeats'] repeats of the same gradient the error feedback
    telescopes (the accumulated mean at least twice as close as one
    shot, as JAX's test asserts).  Times it beside NCCL's ``all_reduce``
    of the same bytes alone."""
    group = mesh.get_group("data")
    gen = torch.Generator("cuda").manual_seed(SEED)
    g = torch.randn(COMPRESS["shape"], generator=gen, device="cuda")
    err0 = dist_mod.CompressionState.zeros_like(g).error
    mean, err = dist_mod.compressed_psum_tree(g, err0, group)
    q, scale = dist_mod._quantize_int8(g + err0)
    deq = q.to(g.dtype) * scale
    if not (torch.equal(mean, deq) and torch.equal(err, g - deq)):
        raise SmokeError("13a: the compressed mean at one rank is not the "
                         "local dequantised value bit for bit")
    one = ((mean - g).norm() / g.norm()).item()
    acc, e = torch.zeros_like(g), err0
    for _ in range(COMPRESS["repeats"]):
        o, e = dist_mod.compressed_psum_tree(g, e, group)
        acc += o
    rel = ((acc / COMPRESS["repeats"] - g).norm() / g.norm()).item()
    if not (one < 0.02 and rel < one / 2):
        raise SmokeError(f"13a: error feedback: one shot {one:.3e}, "
                         f"{COMPRESS['repeats']} repeats {rel:.3e}")
    t_c = measure.time_cuda(lambda: dist_mod.compressed_psum_tree(
        g, err0, group), warmup=2, iters=5, reps=5).wall_s * 1e3
    buf = g.clone()
    t_ar = measure.time_cuda(lambda: torch.distributed.all_reduce(
        buf, group=group), warmup=2, iters=20, reps=5).wall_s * 1e3
    nbytes = g.numel() * g.element_size()
    print(f"  13a compressed_psum_tree on a {tuple(g.shape)} float32 leaf "
          f"(granite-8b's wq, {nbytes / 1e6:.1f} MB): bit-exact to the "
          f"local dequantised value; one shot {one:.3e} from exact, "
          f"{COMPRESS['repeats']} repeats with error feedback {rel:.3e}; "
          f"{t_c:.4f} ms a call, NCCL all_reduce of the same bytes alone "
          f"{t_ar:.4f} ms (world size 1: no wire)")
    return {"one_shot_rel": one, "repeats_rel": rel, "ms": t_c,
            "all_reduce_ms": t_ar, "bytes": nbytes}


def timeline(fn) -> dict:
    """``torch.profiler`` over one call of ``fn``: the host seconds, the
    card's busy share of the window from its first kernel's start to its
    last one's end (the union of kernel spans), and the longest idle
    gaps between kernels — where the card waited on the host."""
    from torch.profiler import ProfilerActivity, profile as prof
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in p.events() if _is_cuda(e)
                   and not e.is_user_annotation)
    if not spans:
        raise SmokeError("13b profile: no kernel on the card's timeline")
    busy, gaps, end = 0.0, [], spans[0][0]
    for a, b in spans:
        if a > end:
            gaps.append(a - end)
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = end - spans[0][0]
    return {"host_s": host_s, "window_us": window, "busy_us": busy,
            "busy_share": busy / window, "kernels": len(spans),
            "longest_gaps_us": sorted(gaps, reverse=True)[:5]}


def vocab_shards_on_card(model, params, batch: dict, rule, mesh) -> dict:
    """13b: the vocab-parallel loss on the card's torch and NCCL.  At one
    rank ``train.step._vocab_split`` sends the loss down the unsharded
    ops, so 13b's steps do not run its vocab-shard body
    (``_vocab_lse_and_label``); here it runs with the split forced onto
    the (1, 1) mesh's `model` dim (each
    all-reduce over one rank), on the float32 logits of one microbatch
    from 13b's trained parameters, each row weighted by a seeded normal
    ``w``.  The log-sum-exp, the label pick and the gradient of
    ``sum(w * (lse - picked))`` are held against ``torch.logsumexp`` and
    ``gather`` on the whole tensor within VOCAB_TOL, relative to the
    largest entry."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.models.common import sharded
    from repro_torch.train import step as step_mod
    mb = {n: x[:1] for n, x in batch.items()}
    with torch.no_grad(), sharded(rule):
        logits = model.forward(params, mb, remat=False, rule=rule)
    given = logits.placements
    vd, rows = 1, (Shard(0), Replicate())        # (data, model)
    lg = logits[:, :-1].float().redistribute(mesh, (Shard(0), Shard(2))) \
        .detach().requires_grad_()
    del logits
    labels = mb["labels"][:, :-1]
    w = torch.randn(tuple(lg.shape[:2]), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED))
    with sharded(rule):
        lse, picked = step_mod._vocab_lse_and_label(lg, labels, vd, rows)
        (distribute_tensor(w, mesh, rows) * (lse - picked)).sum().backward()
    full = lg.full_tensor().detach().requires_grad_()
    if isinstance(labels, DTensor):
        labels = labels.full_tensor()
    want_lse = torch.logsumexp(full, -1)
    want_pick = torch.gather(full, -1, labels.long()[..., None])[..., 0]
    (w * (want_lse - want_pick)).sum().backward()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    errs = {"logsumexp": rel(lse.full_tensor(), want_lse),
            "label_pick": rel(picked.full_tensor(), want_pick),
            "grad": rel(lg.grad.full_tensor(), full.grad)}
    print(f"    13b vocab shards forced on `model` (logits "
          f"{tuple(full.shape)} float32, the rule's placements {given}; "
          f"torch {torch.__version__}): log-sum-exp "
          f"{errs['logsumexp']:.2e}, label pick {errs['label_pick']:.2e}, "
          f"gradient {errs['grad']:.2e} from the whole tensor's, relative "
          f"(bound {VOCAB_TOL})")
    if not all(e <= VOCAB_TOL for e in errs.values()):
        raise SmokeError(f"13b: the vocab-parallel loss {errs} from "
                         f"torch.logsumexp and gather (bound {VOCAB_TOL})")
    return errs


def train_sharded(fa, mesh, measure, space, h100, card: str,
                  ref: dict) -> tuple:
    """13b: 10b again — granite-8b at its published widths cut to
    TRAIN['layers'], ``Trainer`` with ``TrainConfig``'s defaults, the same
    seeds and batches — with ``rule=rule_for(cfg, train_4k)`` on the
    (1, 1) mesh: the parameters, the optimizer state and the batches are
    DTensors, and the flash kernel runs on each rank's (batch, head)
    shard under ``local_map``.  One warm-up step and TRAIN['timed'] timed
    ones (CUDA events); each step's loss and grad norm within
    SHARDED_TOL of 10b's, the same flash launches and backwards a step;
    then one step under ``torch.profiler`` (busy share, longest gaps)
    and the flash call at the shard's shape.  Returns the kernels-line
    entry and the numbers."""
    from repro_torch import configs, train
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import cell
    from repro_torch.models import common, lm
    cfg = train_cfg(configs, TRAIN["layers"])
    model = lm.LM(cfg)
    rule = cell.rule_for(cfg, configs.SHAPES["train_4k"], multi_pod=False)
    bound = train_bound(cfg, model, h100)
    data = SyntheticLM(vocab=cfg.vocab, seq=TRAIN["seq"],
                       global_batch=TRAIN["batch"], seed=SEED)
    tcfg = train.TrainConfig(microbatches=TRAIN["microbatches"])
    trainer = train.Trainer(model, data, tcfg, rule=rule, mesh=mesh)
    rec = _timed_steps(trainer, fa)
    n_steps = TRAIN["warmup"] + TRAIN["timed"]
    held = settled_memory()
    counts = fa.flash_attention.launches_by_route
    for r in counts:
        counts[r] = 0
    zero_backward(fa)
    t0 = time.perf_counter()
    params, opt, step = trainer.run(
        n_steps, generator=torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(counts)
    backward_calls = dict(fa.flash_attention.backward_calls_by_route)
    peak = torch.cuda.max_memory_allocated()
    log = [m for m in trainer.metrics_log if "loss" in m]
    restarts = [m for m in trainer.metrics_log if m.get("event")]
    ms = [s.elapsed_time(e) for s, e in rec["events"]]
    med = statistics.median(ms[TRAIN["warmup"]:])
    tps = bound["tokens"] / (med / 1e3)
    per_step = 2 * cfg.n_layers * TRAIN["microbatches"]
    dtensors = all(type(t).__name__ == "DTensor"
                   for t in common.leaves(params) + common.leaves(opt))
    print(f"  13b {cfg.name}, 10b's cell on a (1, 1) mesh under "
          f"rule_for(train_4k) (params, state and batches DTensors: "
          f"{dtensors}); mesh {mesh}")
    worst = 0.0
    for m, t, n, b, lw, gw in zip(log, ms, rec["launches"], rec["backward"],
                                  ref["losses"], ref["grad_norms"]):
        dl = abs(m["loss"] - lw) / abs(lw)
        dg = abs(m["grad_norm"] - gw) / abs(gw)
        worst = max(worst, dl, dg)
        print(f"    step {m['step']}: {t:.1f} ms (CUDA events; host "
              f"{m['dt'] * 1e3:.1f} ms), loss {m['loss']:.4f} (10b "
              f"{lw:.4f}, {dl:.2e}), grad_norm {m['grad_norm']:.4f} (10b "
              f"{gw:.4f}, {dg:.2e}); flash launches {n}, backwards {b}")
    print(f"    timed steps: median {med:.1f} ms = {tps:,.0f} tokens/s (10b: "
          f"{ref['median_ms']:.1f} ms = {ref['tokens_per_s']:,.0f} "
          f"tokens/s; ratio {med / ref['median_ms']:.3f}); peak memory "
          f"{peak / 1e9:.2f} GB, {held / 1e9:.2f} GB of it held before the "
          f"run (10b {ref['peak_bytes'] / 1e9:.2f} GB, "
          f"{ref['held_bytes'] / 1e9:.2f}); "
          f"wall {wall:.1f} s for {n_steps} steps; {len(restarts)} "
          f"restarts; flash launches {launches}, backwards "
          f"{backward_calls}; on {card}")
    if not dtensors or step != n_steps or restarts:
        raise SmokeError(f"13b: DTensors {dtensors}, {len(restarts)} "
                         f"restarts, ended at step {step}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in log) or not worst <= SHARDED_TOL:
        raise SmokeError(f"13b: a loss or grad norm {worst:.3e} from 10b's "
                         f"(bound {SHARDED_TOL}), or not finite")
    bad = [n for n in rec["launches"] if n["wgmma"] != per_step
           or sum(n.values()) != per_step]
    if bad or any(b != {"kernel": per_step // 2, "plain": 0}
                  for b in rec["backward"]):
        raise SmokeError(f"13b: flash launches a step {rec['launches']} and "
                         f"backwards {rec['backward']}, where each step "
                         f"takes {per_step} wgmma launches and "
                         f"{per_step // 2} kernel backwards, none plain")
    checks = rec["checks"]
    flash = unit_normal_checks(fa, checks["flash"], "13b first step")
    back = _backward_summary(checks["backward"])
    print(f"    13b first step: {back['calls']} backwards held against "
          f"autograd through plain, worst {back['worst_of_tol']:.3f} of the "
          "tolerance")
    batch = trainer._batch(step)
    tl = timeline(lambda: trainer.step_fn(params, opt, batch, step))
    print(f"    torch.profiler, one step: host {tl['host_s'] * 1e3:.1f} ms "
          f"(10b's profiled step {ref['profile']['host_s'] * 1e3:.1f} ms); "
          f"the card busy {tl['busy_us'] / 1e3:.1f} of "
          f"{tl['window_us'] / 1e3:.1f} ms ({tl['busy_share']:.1%}) over "
          f"{tl['kernels']} kernels; longest idle gaps "
          f"{[round(g / 1e3, 2) for g in tl['longest_gaps_us']]} ms")
    vocab = vocab_shards_on_card(model, params, batch, rule, mesh)
    del params, opt, trainer, batch
    torch.cuda.empty_cache()
    entry, _ = train_flash_timing(cfg, fa, space, measure, h100,
                                  "13b flash at a rank's (batch, head) "
                                  "shard", mesh=mesh, rule=rule)
    entry["name"] = f"flash_attention[{TRAIN_ARCH} train, DTensor (1, 1)]"
    entry["launches"] = launches["wgmma"]
    entry["backward_calls"] = backward_calls
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               flash["unit_normal_max_abs_err"])
    numbers = {"step_ms": ms, "median_ms": med, "tokens_per_s": tps,
               "peak_bytes": peak, "held_bytes": held,
               "ratio_to_10b": med / ref["median_ms"],
               "losses": [m["loss"] for m in log],
               "grad_norms": [m["grad_norm"] for m in log],
               "worst_from_10b": worst, "launches_per_step": rec["launches"],
               "backwards_per_step": rec["backward"], "profile": tl,
               "flash_checks": flash, "backward_checks": back,
               "vocab_shards": vocab}
    return entry, numbers


def gpipe_on_card(dist_mod, mesh_mod, fa) -> dict:
    """13c: ``gpipe`` at one stage (a (1,) `pod` mesh: the permutation is
    the identity) over GPIPE['microbatches'] microbatches: one granite-8b
    block (attention and MLP) at its published widths, bf16, on a
    seeded batch, against the block applied to the whole batch; the
    flash kernel launches once a microbatch."""
    from repro_torch import configs
    from repro_torch.models import common, lm
    cfg = train_cfg(configs, 1)
    model = lm.LM(cfg)
    params = common.materialize(model.param_recs(),
                                torch.Generator("cuda").manual_seed(SEED))
    ws = params["stages"][0]["blocks"]          # leading dim: 1 stage
    st = model.stages[0]

    def stage(w, h):
        return model._group(st, w, h, None, None, None)
    pmesh = mesh_mod._make_mesh((1,), ("pod",))
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    x = torch.randn(GPIPE["batch"], GPIPE["seq"], cfg.d_model,
                    generator=gen, device="cuda").to(torch.bfloat16)
    counts = fa.flash_attention.launches_by_route
    with torch.no_grad():
        for r in counts:
            counts[r] = 0
        y = dist_mod.gpipe(stage, pmesh, axis="pod",
                           n_microbatches=GPIPE["microbatches"])(ws, x)
        launches = dict(counts)
        want = stage(common.take(ws, 0), x)
    if y.shape != want.shape:
        raise SmokeError(f"13c: gpipe gave {tuple(y.shape)}, the block "
                         f"{tuple(want.shape)}")
    diff = (y.float() - want.float()).abs()
    err = diff.max().item()
    top = want.float().abs().max().item()
    off = int((diff > GPIPE_TOL * want.float().abs()).sum())
    print(f"  13c gpipe at one stage, {GPIPE['microbatches']} microbatches "
          f"of {tuple(x.shape)} bf16 through one {cfg.name} block (d "
          f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}): max abs "
          f"err {err:.3e} against the block on the whole batch (max |y| "
          f"{top:.2f}); {int((diff > 0).sum())} elements differ, {off} by "
          f"more than {GPIPE_TOL} of their value; flash launches "
          f"{launches}")
    if not torch.isfinite(y.float()).all() or off:
        raise SmokeError(f"13c: gpipe at one stage is {err:.3e} from the "
                         f"block, {off} elements past {GPIPE_TOL} of theirs")
    if launches["wgmma"] != GPIPE["microbatches"]:
        raise SmokeError(f"13c: flash launches {launches}, one a "
                         "microbatch expected")
    return {"max_abs_err": err, "max_abs": top, "launches": launches}


def ckpt_on_card(mesh) -> dict:
    """13d: the reduced granite's parameters and AdamW state (int8 moments)
    placed on the (1, 1) mesh by its rule, saved from the mesh
    (``ckpt.save`` gathers each DTensor) and restored onto it with
    ``shardings=``: every leaf equal bit for bit, with its placements."""
    from repro_torch import ckpt, configs, optim
    from repro_torch.launch import cell
    from repro_torch.models import common, lm
    cfg = configs.reduced(configs.get_config(TRAIN_ARCH))
    model = lm.LM(cfg)
    recs = model.param_recs()
    rule = cell.rule_for(cfg, configs.SHAPES["train_4k"], multi_pod=False)
    ocfg = optim.OptConfig(quantize_state=True)
    sh = {"params": cell.shard(mesh, common.spec_tree(recs, rule)),
          "opt": cell.shard(mesh, cell.opt_specs(recs, rule, ocfg))}
    params = common.materialize(recs,
                                torch.Generator("cuda").manual_seed(SEED),
                                shardings=sh["params"])
    opt = common.tmap(lambda t, s: s.distribute(t),
                      optim.adamw_init(params, ocfg), sh["opt"])
    tree = {"params": params, "opt": opt}
    where = ROOT / "build" / "chip_smoke" / "ckpt13"
    shutil.rmtree(where, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(where, 1, tree)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = ckpt.restore(where, 1, tree, shardings=sh)
    t_restore = time.perf_counter() - t0
    a, b = common.leaves(tree), common.leaves(back)
    same = [torch.equal(x.full_tensor(), y.full_tensor())
            and tuple(x.placements) == tuple(y.placements)
            and x.dtype == y.dtype for x, y in zip(a, b)]
    print(f"  13d {cfg.name} reduced: {len(a)} leaves (bf16 params, int8 "
          f"moments) saved from the mesh in {t_save:.3f} s, restored onto "
          f"it in {t_restore:.3f} s; equal bit for bit with their "
          f"placements: {sum(same)} of {len(same)}")
    if len(a) != len(b) or not all(same):
        raise SmokeError("13d: a restored leaf differs from the saved one")
    return {"leaves": len(a), "save_s": t_save, "restore_s": t_restore}


def distribution(fa, measure, space, h100, card: str, ref: dict) -> tuple:
    """Phase 13: a process group of one rank on NCCL, a (1, 1) mesh on
    the card, then 13a-13d.  Returns 13b's kernels-line entry and the
    numbers."""
    from repro_torch import dist as dist_mod
    from repro_torch.launch import mesh as mesh_mod
    with nccl_world_one() as tdist:
        mesh = mesh_mod.make_local_mesh(1, 1)
        print(f"  NCCL process group, world size {tdist.get_world_size()}, "
              f"backend {tdist.get_backend()}; mesh {mesh} on {card}")
        out = {"compressed": compressed_on_card(dist_mod, mesh, measure)}
        entry, out["train"] = train_sharded(fa, mesh, measure, space, h100,
                                            card, ref)
        torch.cuda.empty_cache()
        out["gpipe"] = gpipe_on_card(dist_mod, mesh_mod, fa)
        out["ckpt"] = ckpt_on_card(mesh)
    return entry, out


# ----------------------------------------------------------------------
# phase 11: graph-level analysis (the HLO parser, hlo-roofline and the
# fleet analyzer), priced on the H100 file and held to the JAX goldens
# ----------------------------------------------------------------------

GOLDENS = ROOT / "benchmarks" / "golden" / "fleet"
# ``python -m repro_torch ARGV`` run by runpy, with the fleet analyzer's
# module walks counted and its service counters written to stderr
FLEET_CHILD = (
    "import json, runpy, sys, time\n"
    "from repro_torch import fleet\n"
    "made, walks = [], [0]\n"
    "init, build = fleet.FleetAnalyzer.__init__, fleet.FleetAnalyzer._build\n"
    "def _init(self, *a, **k):\n"
    "    init(self, *a, **k)\n"
    "    made.append(self)\n"
    "def _build(self, *a, **k):\n"
    "    walks[0] += 1\n"
    "    return build(self, *a, **k)\n"
    "fleet.FleetAnalyzer.__init__ = _init\n"
    "fleet.FleetAnalyzer._build = _build\n"
    "t0 = time.perf_counter()\n"
    "try:\n"
    "    runpy.run_module('repro_torch', run_name='__main__')\n"
    "    rc = 0\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "print(json.dumps({'seconds': time.perf_counter() - t0, "
    "'walks': walks[0], 'service': [a.service.stats.to_dict() "
    "for a in made]}), file=sys.stderr)\n"
    "sys.exit(rc)\n")


def fleet_child(argv: list) -> tuple[str, dict, float]:
    """``python -m repro_torch ARGV`` in a fresh process under
    ``FLEET_CHILD``: standard output, the wrapper's counters (seconds of
    the command, module walks, service counters) and the wall seconds."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FLEET_CHILD] + argv,
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeError(f"fleet child {argv} exited {proc.returncode}: "
                         f"{proc.stderr[-600:]}")
    return proc.stdout, json.loads(proc.stderr.strip().splitlines()[-1]), \
        wall


def fleet_goldens(cli, out: pathlib.Path) -> dict:
    """11a: the 20 artifacts on the paper's and the v5e machine files
    (the port's copies, by alias) against the goldens, through the gate's
    own ``compare``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "fleet_gate", ROOT / "scripts" / "fleet_gate.py")
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    machines = ["IVY", "V5E"]
    argv = ["fleet", "--all", "--out", str(out)]
    for m in machines:
        argv += ["-m", m]
    rc, text, secs = cli_run(cli, argv)
    arts = {p.name: p for p in out.glob("*.json")}
    golds = {p.name: p for p in GOLDENS.glob("*.json")}
    missing = sorted(set(arts) ^ set(golds))
    fails = {n: gate.compare(json.loads(arts[n].read_text()),
                             json.loads(golds[n].read_text()), tol=0.05)
             for n in sorted(set(arts) & set(golds))}
    fails = {n: f for n, f in fails.items() if f}
    pairs = len(set(arts) & set(golds))
    print(f"  11a fleet --all -m IVY -m V5E: exit "
          f"{rc}, {pairs} pairs against benchmarks/golden/fleet, "
          f"{len(fails)} failing, missing {missing}, {secs:.3f} s")
    if rc != 0 or pairs != 20 or fails or missing:
        raise SmokeError(f"11a: fleet goldens: exit {rc}, {pairs} pairs, "
                         f"failures {fails}, missing {missing}")
    return {"pairs": pairs, "host_s": secs}


def fleet_tier(cli) -> dict:
    """Phase 11: 11a the goldens, 11b the ten bundled dumps priced on the
    H100 file in a fresh process, 11c the same from the store, 11d one
    module through ``analyze``."""
    from repro_torch import fleet
    base = ROOT / "build" / "chip_smoke" / "fleet"
    shutil.rmtree(base, ignore_errors=True)
    out = {"goldens": fleet_goldens(cli, base / "goldens")}

    argv = ["fleet", "--all", "-m", "H100", "--out", str(base / "h100"),
            "--cache-dir", str(base / "store"), "--json"]
    cold_out, cold, cold_wall = fleet_child(argv)
    reps = json.loads(cold_out)
    t0 = time.perf_counter()
    want = {c: fleet.FleetAnalyzer().analyze(c, "H100").to_dict()
            for c in fleet.dump_configs()}
    parent_s = time.perf_counter() - t0
    got = {d["config"]: d for d in reps}
    bad = sorted(c for c in want if got.get(c) != want[c])
    print(f"  11b fleet --all -m H100 in a fresh process: {len(reps)} "
          f"reports, {cold['walks']} module walks, all conserving: "
          f"{all(d['conserved'] for d in reps)}, equal to this process's: "
          f"{not bad} (this process: {parent_s:.3f} s for ten)")
    if len(reps) != 10 or bad or not all(d["conserved"] for d in reps) \
            or len(list((base / "h100").glob("*.json"))) != 10:
        raise SmokeError(f"11b: {len(reps)} reports, differing {bad}")
    granite = fleet.FleetReport.from_dict(got["granite-8b"])
    print("\n".join("    " + line for line in granite.render(top=5)
                     .splitlines()))

    warm_out, warm, warm_wall = fleet_child(argv)
    svc = warm["service"]
    disk = sum(s["disk_hits"] for s in svc)
    computed = sum(s["computed"] for s in svc)
    print(f"  11c the same from the store: {disk} disk hits, {computed} "
          f"computed, {warm['walks']} module walks, same output: "
          f"{warm_out == cold_out}")
    print(f"  host seconds (command / process): cold {cold['seconds']:.3f}"
          f" / {cold_wall:.3f}, warm {warm['seconds']:.3f} / "
          f"{warm_wall:.3f}")
    if disk != 10 or computed or warm["walks"] or warm_out != cold_out:
        raise SmokeError(f"11c: warm run: {disk} disk hits, {computed} "
                         f"computed, {warm['walks']} walks")
    out.update(cold_s=cold["seconds"], cold_wall_s=cold_wall,
               warm_s=warm["seconds"], warm_wall_s=warm_wall,
               granite={k: got["granite-8b"][k]
                        for k in ("t_graph", "t_graph_serial", "bottleneck",
                                  "bounds", "module", "totals")})

    dump = SRC / "repro_torch" / "configs" / "hlo" / "granite-8b.hlo.gz"
    rc, text, secs = cli_run(cli, ["analyze", str(dump), "-m", "H100", "-p",
                                   "hlo-roofline", "--json"])
    res = json.loads(text)[0] if rc == 0 else {}
    same = res == got["granite-8b"]["module"]
    print(f"  11d analyze granite-8b.hlo.gz -p hlo-roofline: exit {rc}, "
          f"terms equal to 11b's module roofline: {same} (compute "
          f"{res.get('t_compute', 0) * 1e6:.3f} us, memory "
          f"{res.get('t_memory', 0) * 1e6:.3f} us, collective "
          f"{res.get('t_collective', 0) * 1e6:.3f} us, bound "
          f"{res.get('bottleneck')}; {secs:.3f} s)")
    if not same:
        raise SmokeError("11d: analyze's hlo-roofline differs from the "
                         "fleet report's module roofline")
    return out


# ----------------------------------------------------------------------
# phase 14: graph-level analysis of the port's own programs (the torch
# graph frontend, the dry run on the production meshes, the fleet over
# captured programs), priced on the H100 file
# ----------------------------------------------------------------------

# tests/test_dryrun.py's four cells, each on both production meshes
DRYRUN_CELLS = [("granite-8b", "train_4k"), ("deepseek-v3-671b", "decode_32k"),
                ("mamba2-2.7b", "long_500k"), ("whisper-small", "prefill_32k")]
DRYRUN_TIMEOUT = 600
# the training cells whose escapes once gathered a rank's heads (the SSD
# scan), kept every chunk of the grouped attention alive or held float32
# copies of the logits in the loss (gemma-7b's 16000-column vocab slice),
# on pod16x16 only, each beside the JAX package's own figure for it:
# ``total_per_device`` of ``repro.launch.dryrun.run_cell(arch, "train_4k",
# multi_pod=False)`` (jax 0.9.0 on a host's CPU, 256 forced devices), in
# GiB; the reference counts compiled arguments, outputs and temporaries
# less aliased bytes, the port rank 0's peak of live bytes.  Each must
# read below its figure
TRAIN_CELLS = {"zamba2-7b": 49.68, "mamba2-2.7b": 8.59, "whisper-small": 8.15,
               "gemma-7b": 14.76}
# an H100's memory: a training cell must read below it
CARD_GIB = 80
# calls a turn of the flash operator's host-cost measurement
OP_CALLS = 300
# names phase 14 needs from torch (2.11 on the card machine, 2.13 where the
# port was written), checked before anything relies on them
TORCH_NAMES = ("torch.library.Library", "torch.library.register_fake",
               "torch.ops._dtensor.shard_dim_alltoall",
               "torch.distributed.tensor.placement_types.shard_dim_alltoall",
               "torch._C._current_graph_task_id",
               "torch._subclasses.fake_tensor.FakeTensorMode",
               "torch.utils._python_dispatch.TorchDispatchMode",
               "torch.distributed.tensor._sharding_prop.ShardingPropagator."
               "_propagate_tensor_meta_non_cached")
# an op DTensor has not run before on a fake 4-rank (2, 2) mesh: DTensor
# runs it once on fake tensors of the global (16, 32, 32) shape for its
# result's metadata, which the recorder must skip, then on the local
# (8, 16, 32) shard (tests/test_torch_graph_analysis.py); printed as JSON
META_PROBE = (
    "import json, torch\n"
    "from torch.distributed.tensor import DTensor, Shard\n"
    "from torch._subclasses.fake_tensor import FakeTensorMode\n"
    "from repro_torch.core import graph_analysis as ga\n"
    "from repro_torch.launch import dryrun\n"
    "from repro_torch.launch.mesh import make_local_mesh\n"
    "with dryrun.fake_world(4):\n"
    "    mesh = make_local_mesh(2, 2, device='cpu')\n"
    "    with FakeTensorMode():\n"
    "        sh = DTensor.from_local(torch.empty(8, 16, 32), mesh,\n"
    "                                [Shard(0), Shard(1)], run_check=False)\n"
    "        _, cap = ga.capture(lambda: torch.exp(sh) * sh)\n"
    "print(json.dumps({'ops': [r.opcode for r in cap.analysis.ops],\n"
    "                  'shapes': sorted({r.shape\n"
    "                                    for r in cap.analysis.ops}),\n"
    "                  'temp': cap.peak_bytes - cap.argument_bytes}))\n")
META_WANT = {"ops": ["exp", "mul"], "shapes": ["f32[8,16,32]"],
             "temp": 2 * 4 * 8 * 16 * 32}
# 14b's classes, as 10b's profile names them
STEP_CLASSES = ("GEMM", "flash forward", "attention backward",
                "elementwise", "optimizer")


def torch_names() -> None:
    """Fail loudly when a name phase 14 relies on is missing from this
    torch, or the fake process group cannot be imported."""
    import importlib
    missing = []
    for name in TORCH_NAMES:
        parts = name.split(".")
        obj = None
        for i in range(len(parts), 0, -1):
            try:
                obj = importlib.import_module(".".join(parts[:i]))
            except ImportError:
                continue
            for attr in parts[i:]:
                obj = getattr(obj, attr, None)
            break
        if obj is None:
            missing.append(name)
    try:
        from torch.testing._internal.distributed import fake_pg
        fake_pg.FakeStore
    except (ImportError, AttributeError) as e:
        missing.append(f"fake_pg.FakeStore ({e})")
    print(f"  torch {torch.__version__}: {len(TORCH_NAMES) + 1 - len(missing)}"
          f" of {len(TORCH_NAMES) + 1} names phase 14 relies on present"
          f"{'; missing ' + str(missing) if missing else ''}")
    if missing:
        raise SmokeError(f"14: this torch lacks {missing}")


def operator_cost(fa) -> dict:
    """The host cost of the flash operator: microseconds to enqueue one
    call at 9b's served shape through ``fa.flash_op`` and straight
    through the wrapper at the same blocks, OP_CALLS calls each, in turns
    (three each), with the wall microseconds a call once the card has
    run them."""
    from repro_torch.core import blocking
    q, k, v = (torch.randn(4, 32, 1024, 128, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    tiles = blocking.attention_cta_tiles(1024, 1024, 128, q.dtype)
    bq, bkv = fa.fit_blocks(1024, 1024, tiles.bq, tiles.bkv, 128, q.dtype)
    calls = {
        "operator": lambda: fa.flash_op(q, k, v, True, bq, bkv, 0),
        "wrapper": lambda: fa.flash_attention(q, k, v, causal=True,
                                              block_q=bq, block_kv=bkv,
                                              q_offset=0)}
    got = {n: {"host_us": [], "wall_us": []} for n in calls}
    for _ in range(3):
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OP_CALLS):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            got[name]["host_us"].append((t1 - t0) / OP_CALLS * 1e6)
            got[name]["wall_us"].append((t2 - t0) / OP_CALLS * 1e6)
    med = {n: {k: statistics.median(v) for k, v in r.items()}
           for n, r in got.items()}
    print(f"  the flash operator at (4, 32, 1024, 128) bf16, blocks "
          f"({bq}, {bkv}): host us to enqueue a call "
          + ", ".join(f"{n} {[round(x, 1) for x in r['host_us']]}"
                      for n, r in got.items())
          + "; wall us a call " + ", ".join(
              f"{n} {med[n]['wall_us']:.1f}" for n in med))
    return {"runs": got, "median": med}


def start_meta_probe() -> subprocess.Popen:
    """META_PROBE in a fresh process (its own fake process group)."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-c", META_PROBE], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_meta_probe(proc: subprocess.Popen) -> dict:
    """META_PROBE's result on this torch, held to META_WANT: the recorder
    counts the local-shard ops alone, so DTensor still routes its
    metadata runs through the method the recorder patches."""
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeError(f"14: the metadata-run probe ran past "
                         f"{DRYRUN_TIMEOUT} s")
    if proc.returncode:
        raise SmokeError(f"14: the metadata-run probe exited "
                         f"{proc.returncode}: {err[-1500:]}")
    got = json.loads(out.strip().splitlines()[-1])
    print(f"  14 recorder on torch {torch.__version__}, a new op on a fake "
          f"(2, 2) mesh: ops {got['ops']} at {got['shapes']}, "
          f"{got['temp']} B live (want {META_WANT})")
    if got != META_WANT:
        raise SmokeError(f"14: the recorder counted {got} for the probe, "
                         f"not the local shard's {META_WANT}: DTensor's "
                         "metadata runs no longer pass through "
                         f"{TORCH_NAMES[-1]}")
    return got


def start_dryruns(out: pathlib.Path) -> list:
    """14a's children: ``python -m repro_torch.launch.dryrun --arch A
    --shape S --mesh both`` for each of DRYRUN_CELLS, and ``--shape
    train_4k --mesh single`` for each of TRAIN_CELLS, all started at once
    (each holds its own fake process group)."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = []
    for arch, shape, mesh in ([(a, s, "both") for a, s in DRYRUN_CELLS]
                              + [(a, "train_4k", "single")
                                 for a in TRAIN_CELLS]):
        log = open(out / f"{arch}__{shape}__{mesh}.log", "w+")
        procs.append((arch, shape, mesh, log, time.perf_counter(),
                      subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


def finish_dryruns(procs: list, out: pathlib.Path) -> dict:
    """Wait for 14a's children (DRYRUN_TIMEOUT in all; a child still
    running then is killed and fails the phase) and print each cell's
    report; each of TRAIN_CELLS beside the reference's figure, failing
    the phase at that figure or CARD_GIB or more."""
    deadline = time.perf_counter() + DRYRUN_TIMEOUT
    failed, rows, over = [], {}, []
    for arch, shape, which, log, t0, proc in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        wall = time.perf_counter() - t0
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode != 0:
            failed.append((arch, shape, proc.returncode, text[-1500:]))
            continue
        meshes = ("pod16x16",) if which == "single" else ("pod16x16",
                                                          "pod2x16x16")
        for mesh in meshes:
            rep = json.loads((out / f"{arch}__{shape}__{mesh}.json")
                             .read_text())
            gib = rep["memory"]["total_per_device"] / 2 ** 30
            print(f"  14a {arch} x {shape} x {mesh} ({rep['chips']} ranks): "
                  f"compute {rep['t_compute'] * 1e3:.3f}, memory "
                  f"{rep['t_memory'] * 1e3:.3f}, collective "
                  f"{rep['t_collective'] * 1e3:.3f} ms -> {rep['dominant']};"
                  f" {gib:.2f} GiB a device (arguments "
                  f"{rep['memory']['argument_bytes'] / 2 ** 30:.2f}); "
                  f"collectives {sorted(rep['collective_by_kind'])} "
                  f"({rep['n_collectives']}); {rep['n_ops']} costed ops of "
                  f"{rep['dispatched']} dispatched; host {rep['host_s']:.1f}"
                  f" s in the cell (child {wall:.1f} s)")
            top = rep["top_traffic"][:3]
            print(f"      peak {gib:.2f} GiB a device; top traffic "
                  + "; ".join(f"{t['op']} {t['bytes'] / 2 ** 30:.2f} GiB"
                              for t in top))
            if which == "single":
                ref = TRAIN_CELLS[arch]
                print(f"      {arch} train_4k on {mesh}: the port "
                      f"{gib:.2f} GiB a device against the reference's "
                      f"(the JAX package's run_cell) {ref:.2f} GiB: "
                      f"{gib / ref:.3f}x; under {CARD_GIB} GiB: "
                      f"{gib < CARD_GIB}")
                if gib >= min(ref, CARD_GIB):
                    over.append((arch, round(gib, 2), ref))
            rows[f"{arch}__{shape}__{mesh}"] = {
                **{k: rep[k] for k in ("t_compute", "t_memory",
                                       "t_collective", "dominant", "memory",
                                       "n_collectives", "collective_by_kind",
                                       "mxu_flops", "vpu_flops", "hbm_bytes",
                                       "host_s")},
                "top_traffic": top}
    want = 2 * len(DRYRUN_CELLS) + len(TRAIN_CELLS)
    if failed or len(rows) != want:
        raise SmokeError(f"14a: {len(rows)} of {want} dry-run reports; "
                         f"failed {failed}")
    if over:
        raise SmokeError(f"14a: training cells at the JAX package's figure "
                         f"or {CARD_GIB} GiB a device or more (arch, GiB, "
                         f"JAX's): {over}")
    return rows


def step_class(rec) -> str:
    """A priced record's class among STEP_CLASSES, as 10b's profile
    classes a kernel: the scope it ran in, else its operator."""
    from repro_torch.core import graph_analysis as ga
    if rec.computation in ("attention backward", "optimizer"):
        return rec.computation
    if rec.opcode == "flash_attention_backward":
        return "attention backward"
    if rec.opcode == "flash_attention":
        return "flash forward"
    if rec.opcode in ga.GEMMS:
        return "GEMM"
    return "elementwise"


def priced_capture(what: str, cap, rates, measured_ms: float,
                   profile: dict | None) -> dict:
    """Print a capture's predicted ms (per-op roofline summed, and serial)
    beside its measured ms, the five costliest (operator, shape) groups,
    and, for a train step, the predicted ms by class beside 10b's
    profile."""
    from repro_torch.fleet.pricing import price_ops
    ana = cap.analysis
    priced = price_ops(ana.ops, rates)
    t_graph = sum(p.t_pred for p in priced) * 1e3
    t_serial = sum(p.t_serial for p in priced) * 1e3
    module = max(ana.mxu_flops / rates.mxu_peak, ana.vpu_flops /
                 rates.vpu_peak, ana.hbm_bytes / rates.mem_bandwidth) * 1e3
    print(f"  14b {what}: {len(ana.ops)} costed ops of {cap.n_dispatched} "
          f"dispatched ({cap.seconds:.2f} s recorded); tensor-core "
          f"{ana.mxu_flops / 1e12:.3f} TFLOP, CUDA-core "
          f"{ana.vpu_flops / 1e12:.3f} TFLOP, HBM {ana.hbm_bytes / 1e9:.2f}"
          f" GB; peak {cap.peak_bytes / 1e9:.2f} GB (arguments "
          f"{cap.argument_bytes / 1e9:.2f})")
    print(f"    predicted {t_graph:.1f} ms overlapped (each op's roofline, "
          f"summed), {t_serial:.1f} ms serial, {module:.1f} ms the module's "
          f"roofline; measured {measured_ms:.1f} ms: measured/predicted "
          f"{measured_ms / t_graph:.3f} (overlapped), "
          f"{measured_ms / t_serial:.3f} (serial)")
    groups: dict = {}
    for p in priced:
        g = groups.setdefault((p.op.opcode, p.op.shape, p.op.computation),
                              {"ms": 0.0, "n": 0, "bound": p.bound})
        g["ms"] += p.t_pred * 1e3
        g["n"] += 1
    top = sorted(groups.items(), key=lambda kv: -kv[1]["ms"])[:5]
    for (op, shape, comp), g in top:
        print(f"      {g['ms']:9.3f} ms predicted  x{g['n']:<5d} "
              f"[{g['bound']}] {op} {shape} ({comp})")
    out = {"predicted_ms": t_graph, "predicted_serial_ms": t_serial,
           "module_ms": module, "measured_ms": measured_ms,
           "ratio": measured_ms / t_graph, "ops": len(ana.ops),
           "top": [{"op": k[0], "shape": k[1], "computation": k[2], **v}
                   for k, v in top]}
    if profile:
        by = {c: 0.0 for c in STEP_CLASSES}
        for p in priced:
            by[step_class(p.op)] += p.t_pred * 1e3
        print("    by class, predicted against 10b's torch.profiler device "
              "ms: " + ", ".join(
                  f"{c} {by[c]:.1f}/{profile.get(c, 0.0) / 1e3:.1f}"
                  for c in STEP_CLASSES))
        out["by_class_ms"] = by
    return out


def graph_of_train_step(fa, rates, measured_ms: float, profile: dict
                        ) -> dict:
    """14b: one untimed step of 10b's cell (granite-8b, published widths,
    TRAIN['layers'] layers, 4 microbatches of 4096 tokens) recorded on
    the card, ``flash_attention_backward`` (its plain route's ops; the
    kernel route's operator is classed by name) and ``adamw_update`` in
    scopes of 10b's class names."""
    from repro_torch import configs, train
    from repro_torch.core import graph_analysis as ga
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import step as step_mod
    cfg = train_cfg(configs, TRAIN["layers"])
    data = SyntheticLM(vocab=cfg.vocab, seq=TRAIN["seq"],
                       global_batch=TRAIN["batch"], seed=SEED)
    trainer = train.Trainer(lm.LM(cfg), data, train.TrainConfig(
        microbatches=TRAIN["microbatches"]))
    params, opt, step = trainer.init_state(
        torch.Generator("cuda").manual_seed(SEED))
    batch = trainer._batch(step)
    real_bwd, real_upd = fa.flash_attention_backward, step_mod.adamw_update

    def bwd(*a, **kw):
        with ga.scope("attention backward"):
            return real_bwd(*a, **kw)

    def upd(*a, **kw):
        with ga.scope("optimizer"):
            return real_upd(*a, **kw)
    fa.flash_attention_backward, step_mod.adamw_update = bwd, upd
    try:
        _, cap = ga.capture(trainer.step_fn, params, opt, batch, step)
        torch.cuda.synchronize()
    finally:
        fa.flash_attention_backward, step_mod.adamw_update = \
            real_bwd, real_upd
    flash = sum(1 for r in cap.analysis.ops
                if r.opcode == "flash_attention")
    back = sum(1 for r in cap.analysis.ops
               if r.opcode == "flash_attention_backward")
    per_step = cfg.n_layers * TRAIN["microbatches"]
    if flash != 2 * per_step or back != per_step:
        raise SmokeError(f"14b: {flash} flash and {back} backward operators "
                         f"recorded in a step of {per_step} "
                         "layer-microbatches")
    out = priced_capture(f"granite-8b train step, {cfg.n_layers} layers, "
                         f"{TRAIN['microbatches']} x {TRAIN['seq']} tokens "
                         f"({flash} flash operators)", cap, rates,
                         measured_ms, profile)
    del params, opt, trainer, batch, cap
    torch.cuda.empty_cache()
    return out


def graph_of_prefill(rates, measured_ms: float) -> dict:
    """14b: one untimed prefill of 9b's first bucket (granite-8b at
    published widths and full depth, its padded prompts) recorded on the
    card."""
    from repro_torch.core import graph_analysis as ga
    from repro_torch.models import common
    from repro_torch.models.lm import LM
    from repro_torch.serve import make_caches
    cfg, prompts = serve_case()
    model = LM(cfg)
    params = common.materialize(model.param_recs(),
                                torch.Generator("cuda").manual_seed(SEED),
                                default_dtype=common.dtype_of(cfg.act_dtype))
    toks = bucket_tokens(prompts[:SERVE["batch_size"]])
    caches = make_caches(model, len(toks), SERVE["max_len"], "cuda")
    with torch.inference_mode():
        _, cap = ga.capture(model.prefill, params, {"tokens": toks}, caches)
        torch.cuda.synchronize()
    flash = sum(1 for r in cap.analysis.ops
                if r.opcode == "flash_attention")
    if flash != cfg.n_layers:
        raise SmokeError(f"14b: {flash} flash operators in a prefill of "
                         f"{cfg.n_layers} layers")
    out = priced_capture(f"granite-8b served prefill, bucket 0 "
                         f"{tuple(toks.shape)}, {cfg.n_layers} layers",
                         cap, rates, measured_ms, None)
    del params, caches, cap
    torch.cuda.empty_cache()
    return out


def fleet_of_graphs() -> dict:
    """14c: ``python -m repro_torch fleet --config graph:<arch>`` for the
    ten reduced configs on the H100 file in a fresh process (each capture
    starts its own fake 4-rank process group), beside the bundled dumps'
    reports: the port's tensor-core and CUDA-core flops over JAX's
    lowering's, and each one's collective kinds."""
    from repro_torch import configs, fleet
    out = ROOT / "build" / "chip_smoke" / "fleet_graph"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["fleet", "-m", "H100", "--out", str(out), "--json"]
    for arch in configs.ARCH_IDS:
        argv += ["--config", f"graph:{arch}"]
    text, counters, wall = fleet_child(argv)
    reps = {d["config"]: d for d in json.loads(text)}
    rows = {}
    for arch in configs.ARCH_IDS:
        ours = reps.get(f"graph:{arch}")
        theirs = fleet.FleetAnalyzer().analyze(arch, "H100").to_dict()
        if ours is None or not ours["conserved"]:
            raise SmokeError(f"14c: graph:{arch}: no conserving report")
        mxu = ours["totals"]["mxu_flops"] / theirs["totals"]["mxu_flops"]
        flops = ((ours["totals"]["mxu_flops"] + ours["totals"]["vpu_flops"])
                 / (theirs["totals"]["mxu_flops"]
                    + theirs["totals"]["vpu_flops"]))
        kinds = sorted(ours["module"]["collective_by_kind"])
        jkinds = sorted(theirs["module"]["collective_by_kind"])
        print(f"  14c graph:{arch}: tensor-core flops / JAX's {mxu:.4f}, all "
              f"flops / JAX's {flops:.4f}; predicted "
              f"{ours['t_graph'] * 1e6:.1f} us against the dump's "
              f"{theirs['t_graph'] * 1e6:.1f} us; "
              f"bound {ours['bottleneck']} (JAX's {theirs['bottleneck']}); "
              f"collectives {kinds} (JAX's {jkinds})")
        rows[arch] = {"mxu_ratio": mxu, "flops_ratio": flops,
                      "kinds": kinds, "jax_kinds": jkinds,
                      "t_graph": ours["t_graph"],
                      "jax_t_graph": theirs["t_graph"]}
    print(f"  14c host seconds: {counters['seconds']:.2f} in the command, "
          f"{wall:.2f} in the process")
    return {"configs": rows, "host_s": counters["seconds"], "wall_s": wall}


def graph_level(fa, h100, card: str, predicted: dict) -> dict:
    """Phase 14: the flash operator's host cost; 14a the dry run of
    DRYRUN_CELLS on both production meshes and of TRAIN_CELLS on pod16x16
    in child processes (started
    before 14b; this process holds an NCCL group), 14b 10b's train step
    and 9b's first prefill recorded on the card and priced beside their
    measured ms, 14c the fleet over the captured reduced configs beside
    the bundled dumps."""
    from repro_torch.fleet.pricing import MachineRates
    torch_names()
    cost = operator_cost(fa)      # before the children share the host
    out = ROOT / "build" / "chip_smoke" / "dryrun"
    procs = start_dryruns(out)
    probe = start_meta_probe()
    rates = MachineRates.from_machine(h100)
    print(f"  14b on {card}, priced on {rates.machine}: tensor cores "
          f"{rates.mxu_peak / 1e12:.0f}, CUDA cores "
          f"{rates.vpu_peak / 1e12:.1f} TFLOP/s, HBM "
          f"{rates.mem_bandwidth / 1e12:.2f} TB/s; TF32 "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}")
    try:
        train = predicted["train"]
        step = graph_of_train_step(fa, rates, train["median_ms"],
                                   train["profile"]["classes"])
        prefill = graph_of_prefill(rates,
                                   predicted["serve"]["prefill_ms"][0])
    except BaseException:
        for *_, proc in procs:
            proc.kill()
        probe.kill()
        raise
    try:
        meta = finish_meta_probe(probe)
    except BaseException:
        for *_, proc in procs:
            proc.kill()
        raise
    dry = finish_dryruns(procs, out)
    fleet = fleet_of_graphs()
    return {"dryrun": dry, "train_step": step, "prefill": prefill,
            "fleet": fleet, "operator": cost, "metadata_probe": meta}


# ----------------------------------------------------------------------
# phase 15: the port's examples, each a child process as a user runs it
# ----------------------------------------------------------------------
#: (script, its arguments, the route line it must print: a regular
#: expression); the four card examples run on the card, the pipeline on 8
#: gloo ranks on the CPU (the card machine has one card)
EXAMPLES = [
    ("torch_quickstart", [],
     r"route: cuda \(src/repro_torch/csrc/stencil3d7pt\.cu\), 1 launch"),
    ("torch_stencil_modeling", [],
     r"route: cuda \(src/repro_torch/csrc/longrange3d\.cu\), 1 launch"),
    ("torch_serve_batched", [], r"route: flash attention \{'wgmma': \d+"),
    ("torch_train_100m", ["--ckpt-dir", "CKPT"],
     r"route: flash attention \{'wgmma': \d+"),
    ("torch_multipod_pipeline", ["--device", "cpu", "--ranks", "8"],
     r"GPipe over 8 pods == sequential forward .*max abs err"),
]
EXAMPLE_TIMEOUT = 240


def run_examples(card: str) -> dict:
    """Phase 15: each of EXAMPLES in turn as a child process from the
    checkout's root (``PYTHONPATH=src``; the libraries phase 2 built are
    loaded, not rebuilt), under EXAMPLE_TIMEOUT: it must exit 0 (each
    holds its kernel, or the pipeline its result, against the plain
    version and raises otherwise) and print its route line.  Prints each one's wall seconds and its last
    lines."""
    work = ROOT / "build" / "chip_smoke" / "examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    rows, failed = {}, []
    for name, argv, route in EXAMPLES:
        argv = [str(work / "train_100m") if a == "CKPT" else a for a in argv]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "examples" / f"{name}.py"),
                 *argv], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=EXAMPLE_TIMEOUT)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", str(e.stdout or ""), str(e.stderr or "")
        wall = time.perf_counter() - t0
        found = re.search(route, out)
        print(f"  15 {name} {' '.join(argv)}: exit {rc} in {wall:.1f} s; "
              f"{found.group(0) if found else 'no route line'}")
        for line in out.strip().splitlines()[-5:]:
            print(f"      {line}")
        rows[name] = {"rc": rc, "seconds": wall,
                      "route": found.group(0) if found else None,
                      "tail": out.strip().splitlines()[-12:]}
        if rc != 0 or not found:
            failed.append((name, rc, err[-1500:]))
    print(f"  card: {card}")
    if failed:
        raise SmokeError(f"15: examples failed: {failed}")
    return rows


def smoke(out_path: str | None) -> int:
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is False: this smoke "
                         "test runs on a CUDA card only")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SmokeError(f"no src/repro_torch beside {__file__}: run it "
                         "from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch import tune as tune_mod
    from repro_torch.core import api, blocking, cachesim, incore, predictors
    from repro_torch.core import machine as machine_mod
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.tune import measure, space, stencil, sweep

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi()
    props = torch.cuda.get_device_properties(0)
    h100 = machine_mod.load("H100")
    print(f"device {kind!r}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {card}")
    print(f"SMs {props.multi_processor_count} (machine file "
          f"{h100.extra['SM count']}), L2 "
          f"{getattr(props, 'L2_cache_size', 0)} B (machine file "
          f"{h100.levels[-1].size_bytes:.0f} B)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"built {sorted(info)} in {time.perf_counter() - t0:.1f} s "
          "(parallel nvcc, sm_90a)")
    hgmma = check_build(_build, fa, info)
    check_simt_build(fa, space, info)
    check_stencil_build(_build, ops, stencil, info)

    phase("3 check against the plain versions on the card")
    max_err = {}
    for name in MAIN:
        fam = stencil.family(name)
        for shape in RAGGED + [MAIN[name]]:
            err = check_kernel(name, shape, fam, stencil, ops)
            max_err[name] = max(max_err.get(name, 0.0), err)
    split_err = check_split(fa)
    fa_err = check_flash(fa, ops, space)
    bwd_check = check_backward(fa, space, measure, h100)

    phase("3b the SSD scan at mamba2-2.7b's training shape")
    ssd_entry = ssd_phase(measure, h100, card)

    phase("4 main path at full size")
    # each family's kernel wrapper carries the family's name
    wrappers = {n: getattr(stencil.family(n).module, n) for n in MAIN}
    for w in wrappers.values():
        w.launches = 0
    runs = {name: main_path(name, stencil.family(name), stencil, measure)
            for name in MAIN}
    launches = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches during the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise SmokeError(f"main path never launched the {name} kernel")
    entries, predicted = [ssd_entry], {}
    for name, run in runs.items():
        e = report(name, run, stencil, measure, h100, card, ops, sweep)
        e["launches"] = launches[name]
        e["max_abs_err"] = max(max_err[name], e["max_abs_err"])
        predicted[name] = {"ecm_ms": run["pred"].ecm_s * 1e3,
                           "roofline_ms": run["pred"].roofline_s * 1e3}
        entries.append(e)
        del run["args"], run["out"]
        torch.cuda.empty_cache()

    phase("4b tune the stencils on the H100")
    stencil_tunes = {name: stencil_tune(name, tune_mod, space, stencil,
                                        machine_mod, fresh=i == 0)
                     for i, name in enumerate(MAIN)}
    cal_copy = calibration_copy(tune_mod)
    predicted["regime_changes"] = {
        name: regime_changes(name, space, api, blocking, h100)
        for name in MAIN}
    predicted["block_sizes"] = block_sizes(api, blocking, h100)
    for name in MAIN:
        unc, ms = runs[name]["pred"], runs[name]["t_kernel"].wall_s * 1e3
        cal = stencil.predict_seconds(name, MAIN[name], str(cal_copy),
                                      calibrated=True)
        print(f"  {name} {MAIN[name]} measured {ms:.4f} ms: ECM "
              f"{unc.ecm_s * 1e3:.4f} ms uncalibrated (measured/predicted "
              f"{ms / (unc.ecm_s * 1e3):.3f}), {cal.ecm_s * 1e3:.4f} ms "
              f"calibrated (measured/predicted {ms / (cal.ecm_s * 1e3):.3f}"
              f"), {cal.ecm.notation()} overlapped "
              f"{[(n, round(c, 3)) for n, c in cal.ecm.overlapped]}")
        stencil_tunes[name]["ecm_calibrated_ms"] = cal.ecm_s * 1e3
        stencil_tunes[name]["ecm_uncalibrated_ms"] = unc.ecm_s * 1e3
        stencil_tunes[name]["main_path_ms"] = ms
        predicted[f"tune_{name}"] = stencil_tunes[name]

    phase("4c SIM and ports on the H100")
    predicted["sim_ports"] = sim_and_ports(
        {n: runs[n]["t_kernel"].wall_s * 1e3 for n in MAIN}, stencil, h100,
        predictors, cachesim, incore)

    phase("8 the analysis tier: lint, analyze, the store and its pool")
    counters = {n: w for n, w in wrappers.items()}
    counters["flash_attention"] = fa.flash_attention
    predicted["analysis_tier"] = analysis_tier(counters)
    for e in entries:
        if e["name"] == "stencil3d7pt":
            e["analysis_tier_launches"] = \
                predicted["analysis_tier"]["tune"]["launches"]

    phase("5 tune flash_attention at granite-8b's attention")
    counts = fa.flash_attention.launches_by_route
    for r in counts:
        counts[r] = 0
    for w in wrappers.values():
        w.launches = 0
    fa_run = tune_path(fa, space, tune_mod, measure, machine_mod, GRANITE,
                       "wgmma", calibrate=True)
    fa_launches = dict(counts)
    print(f"  launches in this process during the tune path: {fa_launches} "
          "(the measuring runs are in child processes)")
    if fa_launches["wgmma"] <= 0:
        raise SmokeError("tune path never launched the wgmma flash kernel")
    rep = fa_run["report"]
    predicted["flash_attention"] = {
        "tuner_predicted_ms": rep.predicted_chosen_s * 1e3,
        "candidates": [c.to_dict() for c in rep.measured_outcomes],
        "calibration": rep.calibration,
        "chosen": rep.chosen_params, "default": rep.default_params}
    flash_runs = {"wgmma": fa_run}
    launches.update({FA_ENTRY["wgmma"]: fa_launches["wgmma"]})

    phase("6 the same attention in float32: tune on bf16x3, then simt")
    for r in counts:
        counts[r] = 0
    fa.split_bf16x3.launches = 0
    flash_runs["bf16x3"] = tune_path(fa, space, tune_mod, measure,
                                     machine_mod, GRANITE_F32, "bf16x3",
                                     calibrate=False)
    flash_runs["simt"] = simt_path(fa, space, measure)
    fa_launches = dict(counts)
    split_launches = fa.split_bf16x3.launches
    print(f"  launches in this process during the f32 path: {fa_launches}, "
          f"split {split_launches} (the measuring runs are in child "
          "processes)")
    for r in ("bf16x3", "simt"):
        if fa_launches[r] <= 0:
            raise SmokeError(f"f32 path never launched the {r} flash kernel")
        launches[FA_ENTRY[r]] = fa_launches[r]
    if split_launches <= 0:
        raise SmokeError("f32 path never launched the bf16x3 split kernel")
    rep = flash_runs["bf16x3"]["report"]
    predicted["flash_attention_f32"] = {
        "tuner_predicted_ms": rep.predicted_chosen_s * 1e3,
        "candidates": [c.to_dict() for c in rep.measured_outcomes],
        "calibration": rep.calibration,
        "chosen": rep.chosen_params, "default": rep.default_params}
    yard: dict = {}
    for route, run in flash_runs.items():
        e = flash_report(run, fa, space, measure, h100, card, yard)
        dtype = str(run["qkv"][0].dtype)[6:]
        e["launches"] = launches[e["name"]]
        e["max_abs_err"] = max(fa_err.get((route, dtype), 0.0),
                               e["max_abs_err"])
        if route == "bf16x3":
            e.update(split_launches=split_launches,
                     split_max_abs_err=split_err)
        if route == "simt":   # the same kernel in bf16, off the wgmma set
            e["max_abs_err_bfloat16"] = fa_err[("simt", "bfloat16")]
        entries.append(e)
        run.clear()
        torch.cuda.empty_cache()
    predicted["hgmma_in_sass"] = hgmma

    phase("7 gemma-7b's and zamba2-7b's attention on the tensor cores")
    for model in REAL_MODELS:
        for dtype in ("bfloat16", "float32"):
            for r in counts:
                counts[r] = 0
            fa.split_bf16x3.launches = 0
            e = model_path(model, dtype, fa, space, measure, h100, card)
            by_route = dict(counts)
            print(f"    launches: {by_route}, split "
                  f"{fa.split_bf16x3.launches}")
            route = TC_ROUTE[fa.torch_dtype(dtype)]
            split = fa.split_bf16x3.launches
            if by_route[route] <= 0 or by_route["simt"] <= 0 or \
                    (route == "bf16x3") != (split > 0):
                raise SmokeError(f"{model} {dtype} never launched {route} "
                                 "or simt, or its split pass is amiss")
            e["launches"] = by_route[route]
            e["simt_launches"] = by_route["simt"]
            if split:
                e["split_launches"] = split
            entries.append(e)
            torch.cuda.empty_cache()
    for r in counts:
        counts[r] = 0
    gemma = {**REAL_MODELS["gemma-7b"], "dtype": "bfloat16"}
    g_run = tune_path(fa, space, tune_mod, measure, machine_mod, gemma,
                      "wgmma", calibrate=False)
    print(f"  chosen {g_run['blocks']} in this process: "
          f"{g_run['t_kernel'].wall_s * 1e3:.4f} ms; launches {dict(counts)}")
    if counts["wgmma"] <= 0:
        raise SmokeError("the gemma-7b tune never launched wgmma")
    rep = g_run["report"]
    predicted["flash_attention_gemma_7b"] = {
        "tuner_predicted_ms": rep.predicted_chosen_s * 1e3,
        "candidates": [c.to_dict() for c in rep.measured_outcomes],
        "chosen": rep.chosen_params, "default": rep.default_params}
    g_run.clear()
    torch.cuda.empty_cache()

    phase("9 serve granite-8b")
    from repro_torch import configs
    from repro_torch.models import common, lm
    print(f"  9a every family, reduced, on the card against the CPU "
          f"(rule: |card - f32| <= {BF16_FACTOR} |cpu - f32| + "
          f"{BF16_SLACK}; forward, prefill and {REDUCED_STEPS} decode "
          "steps)")
    predicted["reduced_on_card"] = {
        arch: reduced_on_card(arch, fa, configs, common, lm)
        for arch in configs.ARCH_IDS}
    for arch, r in predicted["reduced_on_card"].items():
        cfg = configs.reduced(configs.get_config(arch))
        causal = _causal(cfg, lm)
        if causal and sum(r["launches"].values()) <= 0:
            raise SmokeError(f"9a {arch}: causal attention never reached "
                             "the flash kernel on the card")
    entry, predicted["serve"] = serve_granite(fa, measure, space, h100, card)
    entries.append(entry)

    phase("10 train on the card")
    from repro_torch import optim, train
    print(f"  10a every family, reduced: one train step ({TRAIN_REDUCED}) on "
          f"the card against the CPU (rule: the float32 steps within "
          f"{TRAIN_TOL}; each config's own types printed)")
    predicted["train_reduced"] = {
        arch: reduced_train_on_card(arch, fa, configs, common, lm, train,
                                    optim)
        for arch in configs.ARCH_IDS}
    entry, back_entry, predicted["train"] = train_granite(
        fa, measure, space, h100, card)
    entries.append(entry)
    back_entry["max_abs_err"] = bwd_check["max_abs_err"]
    back_entry["worst_of_tol"] = bwd_check["worst_of_tol"]
    back_entry["flash_phase_ms"] = bwd_check["ms"]
    back_entry["passes_ms"] = bwd_check["passes_ms"]
    entries.append(back_entry)
    torch.cuda.empty_cache()

    phase("13 distribution on the card: NCCL at world size 1")
    entry, predicted["distribution"] = distribution(
        fa, measure, space, h100, card, predicted["train"])
    entries.append(entry)
    torch.cuda.empty_cache()

    phase("11 graph-level analysis: the fleet on the H100 file")
    from repro_torch import cli
    print(f"  host only, no launch; card: {card}")
    predicted["fleet"] = fleet_tier(cli)

    phase("14 graph-level analysis of the port's own programs")
    predicted["graph"] = graph_level(fa, h100, card, predicted)
    torch.cuda.empty_cache()

    phase("15 the port's examples as a user runs them")
    predicted["examples"] = run_examples(card)

    phase("12 result")
    result = {"kernels": entries}
    if out_path:
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out_path).write_text(json.dumps(
            {**result, "predicted": predicted, "card": card, "device": kind,
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "build": info}, indent=2))
    print(f"  [total: {time.perf_counter() - _PHASE['start']:.1f} s]")
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full results as JSON here")
    args = ap.parse_args()
    try:
        return smoke(args.out)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

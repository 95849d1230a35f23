#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure (non-zero exit, no result line), each
followed by its seconds:
  1. device  — name, count, torch/CUDA versions, ``nvidia-smi`` name and
               power limit, SM count and L2 size against the machine file;
  2. build   — the five CUDA sources from ``src/repro_torch/csrc`` with
               nvcc for sm_90a, in parallel; build seconds, the ptxas
               report (registers, spills) of every kernel instantiation
               (the head-dim-256 ones and every stencil instantiation must
               not spill), the advisor's stencil plans (shared bytes,
               threads) against each stencil library's
               ``repro_<kernel>_limits`` at the main-path and ragged
               shapes, the count of HGMMA
               (tensor-core) instructions in each flash library's SASS
               (``cuobjdump -sass``, positive for both tensor-core
               libraries), and the launch limits of every wgmma and bf16x3
               instantiation as the library states them against
               ``launch_limits``, at the instantiated head dims and at 112
               (padded to 128);
  3. check   — each kernel against its plain PyTorch version on the card,
               at the reference tolerances: the stencils at ragged shapes,
               at the ring's edges (N below one tile, M <= 2r, M below
               the stages) and at the main-path shape, each printing its
               launch plan (boundaries bit-exact); the
               bf16x3 split pass bit-exact against ``plain_split``; flash
               attention on all three routes — bf16 on the tensor cores
               ("wgmma"), f32 on the tensor cores as three bf16 passes
               ("bf16x3"), and both types off those sets on the CUDA cores
               ("simt": blocks (64, 32), head_dim 100) — at head_dim
               32/64/96/128/256 and 40/112/136 (padded), causal and full,
               the decode shape (1, 32, 128, 4096), padded q blocks
               (16, 32), and every feasible candidate of the seq-256 tune
               spaces, in both types; each case prints the route whose
               launch counter moved, and the worst error is kept per
               (route, dtype);
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
               at (64, 32), a pair off the bf16x3 set, held and timed;
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
               ``FlashAttentionFn`` against autograd through plain on
               its own operands (FA_TOL of each gradient's largest
               entry).  10b, granite-8b at its published widths (tp=1)
               cut to 8 layers, trained by ``Trainer`` with
               ``TrainConfig``'s defaults (bf16, remat, AdamW with fp32
               master, m and v) on ``SyntheticLM`` at 4096 tokens, batch
               4 in 4 microbatches: one warm-up step (its flash calls
               and backwards held as in 10a) and 4 timed (CUDA events);
               loss, grad norm, lr and the flash launches and backwards
               of each step (64 wgmma launches and 32 backwards each,
               zero restarts), tokens/s, peak memory, the step's bound
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
               SDPA, its bound, the Function's backward and SDPA's
               forward plus backward;
     Launch counters are zeroed just before each main path (4, each
     family of 4b, each tune of 8d, 5, 6, each model and type of 7, each
     config of 9a, 9b's serving, each config of 10a and 10b's training)
     and must be positive just after it (in 6: bf16x3, its split, simt;
     in 8d's replay, zero);
  11. a JSON line naming each ported kernel (flash attention once per
     route, once per route, model and type of 7, once on 9b's serving
     path and once on 10b's training path), then the card's line, then
     ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX or of the JAX package ``repro``; it needs the
repository's ``src/repro_torch`` beside it and a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# set (block_kv 32), the fastest simt pair measured at this shape
SIMT_BLOCKS = (64, 32)
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
# card; 36 layers' 133.7 GB do not, and sharding waits for ROADMAP.md
# Queue 1 item 5), at SHAPES['train_4k']'s 4096 tokens with its global
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
DROP_TOL = 2e-2
BF16_DROP_TOL = 0.9
# heads per slice of the backward check's autograd through plain
BACKWARD_HEADS = 8
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers")


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
    :data:`SIMT_BLOCKS`, a pair off the bf16x3 set."""
    sp = space.resolve_space("flash_attention", "H100", **GRANITE_F32)
    q, k, v = sp.inputs("cuda")
    bq, bkv = SIMT_BLOCKS

    def call():
        return fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    out, route = routed(fa, call)
    if route != "simt":
        raise SmokeError(f"f32 attention at {SIMT_BLOCKS} launched on "
                         f"{route}, not simt")
    t_kernel = measure.time_cuda(call, warmup=1, iters=3, reps=5)
    torch.cuda.synchronize()
    return {"report": None, "qkv": (q, k, v), "out": out, "route": route,
            "blocks": (bq, bkv), "t_kernel": t_kernel}


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


def check_build(_build, fa, info: dict) -> dict[str, int]:
    """The ptxas report (no spill at head dim 256), the HGMMA counts, and
    the tensor-core libraries' launch limits against ``launch_limits``;
    returns the HGMMA count per flash library."""
    for name, d in info.items():
        print(f"  {name}: {d['seconds']:.1f} s")
        for ln in d["ptxas"]:
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
    hgmma = {src: sass_hgmma(_build, src) for src in fa.SOURCES.values()}
    print(f"  HGMMA instructions in the SASS: {hgmma}")
    for route in TC_ROUTE.values():
        if hgmma[fa.SOURCES[route]] <= 0:
            raise SmokeError(f"the {route} library's SASS has no HGMMA "
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
    against autograd through ``fa.plain`` on its own operands (q, k, v
    and the output's gradient), BACKWARD_HEADS heads at a time (plain's
    float32 scores at granite's shape are 2.1 GB for all 32): each of dQ,
    dK and dV within FA_TOL times its largest entry.  The backward's own
    result is what the step uses.  Yields a dict keyed by (q shape, k
    shape, q_offset, dtype) of the calls and their worst error over its
    tolerance."""
    real = fa.attention_backward
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
    fa.attention_backward = check
    try:
        yield seen
    finally:
        fa.attention_backward = real


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
            fa.flash_attention.backward_calls = 0
            card[name] = _one_step(train, optim, common, m, p, batch,
                                   "cuda")
            torch.cuda.synchronize()
            launches[name] = dict(counts)
            backward_calls[name] = fa.flash_attention.backward_calls
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
            sum(launches[n].values()) > 0 and backward_calls[n] > 0
            for n in card):
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
    two) — and beside it the bytes of one AdamW pass at the HBM rate:
    each parameter's float32 gradient, master, m and v read, and its
    master, m, v and bf16 parameter written."""
    n = cfg.param_count()
    embed = model.padded_vocab * cfg.d_model
    tokens = TRAIN["batch"] * TRAIN["seq"]
    s = TRAIN["seq"]
    weights = (2 * n + 2 * (n - embed) + 4 * n) * tokens
    pairs = TRAIN["batch"] * s * (s + 1) // 2
    attention = 4 * 4 * cfg.head_dim * cfg.n_heads * cfg.n_layers * pairs
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
        n0, b0 = dict(counts), fa.flash_attention.backward_calls
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
        rec["backward"].append(fa.flash_attention.backward_calls - b0)
        return out
    trainer.step_fn = step_fn
    return rec


@contextlib.contextmanager
def _first_step_checks(fa):
    with checked_flash(fa) as seen, checked_backward(fa) as back:
        yield {"flash": seen, "backward": back}


#: the ranges 10b's profile puts around the attention backward and the
#: optimizer, and the class of the kernels inside each
TRAIN_RANGES = {"attention_backward": "attention backward",
                "adamw_update": "optimizer"}


def _is_cuda(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def train_profile(fn, fa, step_mod) -> dict:
    """``torch.profiler`` over one call of ``fn`` (a train step), with
    ``attention_backward`` and ``adamw_update`` inside
    ``record_function`` ranges of their names: device microseconds per
    class — GEMM, flash forward, attention backward (all the Function's
    backward's kernels), elementwise, optimizer — and the step's host
    seconds.  A kernel belongs to a range when it starts within the
    range's span on the card's timeline (the profiler's GPU user
    annotation); the others are classed by name."""
    from torch.profiler import ProfilerActivity, profile as prof
    from torch.profiler import record_function
    real_bwd, real_upd = fa.attention_backward, step_mod.adamw_update

    def bwd(*a, **kw):
        with record_function("attention_backward"):
            return real_bwd(*a, **kw)

    def upd(*a, **kw):
        with record_function("adamw_update"):
            return real_upd(*a, **kw)
    fa.attention_backward, step_mod.adamw_update = bwd, upd
    try:
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    finally:
        fa.attention_backward, step_mod.adamw_update = real_bwd, real_upd
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
        fa.flash_attention.backward_calls = 0
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


def train_flash_timing(cfg, fa, space, measure, h100) -> dict:
    """The flash call of 10b's training, (1, 32, 4096, 128) bf16 causal,
    on seeded unit-normal operands: the kernel, plain, SDPA and the bound
    (the kernels line's numbers); the Function's backward beside SDPA's
    forward plus backward, the yardstick."""
    from repro_torch.kernels import ops
    shape = (1, cfg.n_heads, TRAIN["seq"], cfg.head_dim)
    q, k, v = qkv(shape, TRAIN["seq"], torch.bfloat16, SEED)
    do = qkv(shape, TRAIN["seq"], torch.bfloat16, SEED + 1)[0]

    def kernel():
        return ops.flash_attention(q, k, v, causal=True, q_offset=0)

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
    t_plain = measure.time_cuda(lambda: fa.plain(q, k, v, q_offset=0),
                                warmup=1, iters=1, reps=3).wall_s * 1e3
    t_sdpa = measure.time_cuda(sdpa, warmup=2, iters=5, reps=5).wall_s * 1e3
    t_bwd = measure.time_cuda(
        lambda: fa.attention_backward(q, k, v, do, causal=True,
                                      q_offset=0),
        warmup=1, iters=2, reps=3).wall_s * 1e3
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=True).backward(do)
    t_sdpa_fb = measure.time_cuda(sdpa_fwd_bwd, warmup=2, iters=5,
                                  reps=5).wall_s * 1e3
    bound = space.attention_bound(q, k, causal=True, q_offset=0,
                                  machine=h100)
    b_ms = bound.seconds * 1e3
    print(f"  10b flash at the training shape {shape} bf16 causal, route "
          f"{route}: kernel {t_fa:.4f} ms ({b_ms / t_fa:.1%} of its bound "
          f"{b_ms:.4f} ms by {bound.by}), plain {t_plain:.4f} ms, SDPA "
          f"{t_sdpa:.4f} ms; max abs err vs plain {err:.3e}")
    print(f"    the Function's backward (PyTorch, float32 scores, no "
          f"kernel) {t_bwd:.4f} ms; SDPA forward + backward {t_sdpa_fb:.4f} "
          f"ms (yardstick only); the backward's bound (two attention "
          f"passes) {2 * b_ms:.4f} ms")
    return {"name": f"flash_attention[{TRAIN_ARCH} train]", "route": "cuda",
            "source": f"src/repro_torch/csrc/{fa.SOURCES[route]}.cu",
            "replaces": REPLACES["flash_attention"], "launches": 0,
            "max_abs_err": err, "ms": t_fa, "plain_ms": t_plain,
            "bound_ms": b_ms, "bound_by": bound.by, "library_ms": t_sdpa,
            "shape_q": list(shape), "backward_ms": t_bwd,
            "sdpa_fwd_bwd_ms": t_sdpa_fb}


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
    call's times.  Returns the kernels-line entry and the numbers."""
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
    torch.cuda.reset_peak_memory_stats()
    counts = fa.flash_attention.launches_by_route
    for r in counts:
        counts[r] = 0
    fa.flash_attention.backward_calls = 0
    t0 = time.perf_counter()
    params, opt, step = trainer.run(
        n_steps, generator=torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(counts)
    backward_calls = fa.flash_attention.backward_calls
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
    print(f"    peak memory allocated {peak / 1e9:.2f} GB; {len(restarts)} "
          f"restarts; wall {wall:.1f} s for {n_steps} steps; flash launches "
          f"{launches}, backwards {backward_calls}")
    if step != n_steps or restarts:
        raise SmokeError(f"10b: {len(restarts)} restarts, ended at step "
                         f"{step}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in log):
        raise SmokeError("10b: a non-finite loss or grad norm")
    bad = [n for n in rec["launches"] if n["wgmma"] != per_step
           or sum(n.values()) != per_step]
    if bad or any(b != per_step // 2 for b in rec["backward"]):
        raise SmokeError(f"10b: flash launches a step {rec['launches']} and "
                         f"backwards {rec['backward']}, where each step "
                         f"takes {per_step} wgmma launches and "
                         f"{per_step // 2} backwards")
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
    entry = train_flash_timing(cfg, fa, space, measure, h100)
    entry["launches"] = launches["wgmma"]
    entry["backward_calls"] = backward_calls
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               flash["unit_normal_max_abs_err"])
    numbers = {"step_ms": ms, "median_ms": med, "tokens_per_s": tps,
               "peak_bytes": peak, "bound": bound,
               "losses": [m["loss"] for m in log],
               "grad_norms": [m["grad_norm"] for m in log],
               "lrs": [m["lr"] for m in log],
               "launches_per_step": rec["launches"],
               "backwards_per_step": rec["backward"],
               "flash_checks": flash, "backward_checks": back,
               "profile": {"classes": pr["classes"],
                           "host_s": pr["host_s"]},
               "drop_check": drop}
    return entry, numbers


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
    entries, predicted = [], {}
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
    entry, predicted["train"] = train_granite(fa, measure, space, h100, card)
    entries.append(entry)

    phase("11 result")
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

#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,train_path,train
    python3 chip_smoke.py --phases build,ssm_path,ssm_serve
    python3 chip_smoke.py --phases build,train_cli
    python3 chip_smoke.py --phases build,ddp_path,ddp
    python3 chip_smoke.py --phases build,ssm_train_path,ssm_train
    python3 chip_smoke.py --phases build,gemma_path,gemma_serve,gemma_train_path,gemma_train
    python3 chip_smoke.py --phases build,serve,train,time \
        --against parent=build/parent/flash_attention.cu

Phases (any failure exits non-zero before the last line):
  build       build the CUDA kernels from src/repro_torch/kernels/csrc/;
              the flash forward and backward (bf16, and f32 on three bf16
              pieces), the bf16 SSD body's product passes, the SSD
              backward's product passes (bf16, and f32 on pieces) and the
              bf16 paged body, at every head dim they take, must run on
              wgmma and TMA alone (SASS: HGMMA and UTMALDG, no HMMA; no
              ptxas C7520), and the flash and SSD backwards' wgmma bodies
              with a stack frame of 0 bytes
  kernels     hold each kernel (forward and backward) against its plain
              PyTorch version (backward: the plain version's autograd) on
              the card, f32 and bf16, at the stated tolerances, up to the
              decode tick's, the training step's and the SSM prefill's
              shapes
  faults      planted faults: builds copies of the kernels with one known
              bug each and checks that the kernel gate fails them (runs
              after ddp; the builds start once the build phase is done, at
              the lowest CPU priority)
  path        starcoder2-3b at full width, depth cut to 2 layers, f32: the
              paged engine on cuda and on cpu (plain versions) must agree on
              prefill and decode logits and give the same greedy tokens
  serve       starcoder2-3b at full width and depth, bf16: 16 requests
              through repro_torch.launch.serve's engine; every prefill and
              decode tick must have gone through the kernels (launch counts)
  ssm_path    mamba2-130m at full width, depth cut to 2 layers, f32: the
              paged engine on cuda and on cpu must agree on prefill and
              decode logits (a 300-token prompt: a full chunk and a ragged
              one) and give the same greedy tokens over 8 decode steps
  gemma_path  gemma3-4b at full width, depth cut to 2 layers (local with
              window 1024, global), f32: as path, prompts of 1500 and 37
              tokens (the long one's ring filled ragged under its bucket,
              then overwritten by its decode)
  gemma_serve gemma3-4b at full width and depth, bf16: 16 requests with
              prompts of 600-3000 tokens; every layer's prefill through
              the flash kernel, every tick the paged kernel in the 5 global
              layers only (the 29 windowed ones decode over their rings)
  ssm_serve   mamba2-130m at full width and depth, bf16: 16 requests; every
              layer of every prefill must have gone through ssd_scan
  train_path  bert-mlm-120m at full width, depth cut to 2 layers, f32: the
              same masked batches and initial parameters on cuda and on cpu
              must agree on the loss, every gradient leaf and 5 steps
  train       bert-mlm-120m at full width and depth, f32 parameters and
              bf16 activations, batch 32 x 512: 20 steps through
              repro_torch.train.trainer.train; the loss must fall and every
              attention and loss chunk, forward and backward, must have
              gone through the kernels (launch counts per step)
  ssm_train_path
              mamba2-130m at full width, depth cut to 2 layers, f32, B 2 x
              S 600 (a full chunk and a ragged one): the same next-token
              batches and initial parameters on cuda and on cpu must agree
              on 3 steps' losses and every gradient leaf of the first; the
              same gradients computed twice on the card are equal bit for
              bit.  The cpu side runs in a process of its own, started
              with the script at nice 15
  gemma_train_path
              gemma3-4b at full width, 2 layers (local, global), f32, B 1 x
              S 1100, 2 steps: as ssm_train_path (the windowed flash
              backward at head dim 256)
  train_cli   bert-mlm-120m at full width and depth, f32 (the launcher's
              defaults), batch 32 x 512 from the DataPipeline over a
              1000-function corpus, through repro_torch.launch.train.main:
              (a) 10 steps with the R3 autotune; (b) the same run with
              sharded checkpoints, stopped after the step-5 one; (d) that
              checkpoint resumed through runner.resume and TrainLoop with
              the device prefetch 4 deep, and (c) through a fresh main
              (depth 2), whose losses at steps 6-10 must each equal (a)'s
              bit for bit; launch counts per step as in train, every batch
              placed by the device prefetch, the loss falling; the
              prefetch's batches equal to the host's at depths 2 and 4
  ssm_train   mamba2-130m at full width and depth, B 16 x S 1024 from the
              DataPipeline: (a) 10 steps of repro_torch.launch.train.main
              at its f32 defaults, checkpointed every 5 steps; (b) (a)'s
              step-5 checkpoint resumed, whose losses at steps 6-10
              must equal (a)'s bit for bit; (c)
              10 steps of trainer.train with bf16 parameters and
              activations at microbatch 2, every gradient handed to AdamW
              in f32; the loss falls in each, and every SSD scan and loss
              chunk, forward and backward, goes through the kernels
              (launch counts per step); step time, MFU and device busy
  gemma_train gemma3-4b at full width, depth cut to 6 (5 local, 1 global), B
              4 x S 2048 from the DataPipeline with the launcher's rolled
              labels: (a) 10 steps of trainer.train in f32, (b) 10 in bf16
              at microbatch 2; the loss falls, launches per step exact
              (2L flash forwards, L backwards, 2C and C xent at V 262144),
              step time, MFU and device busy
  ddp_path    bert-mlm-120m at full width, 2 layers, f32, global batch 8 x
              512 with ragged masks: 2 ranks on the one card over gloo
              (processes spawned by the phase) against one process on the
              card: each summed gradient leaf, at bucket sizes 0.05 and 25
              MB, within 1e-5 of its scale of one process computing the
              same global loss on the ranks' row shards, and within 1e-4
              of the one-process 8-row batch; 5 steps of losses within
              1e-5; one all-reduce per bucket per step, every hook once
  ddp         bert-mlm-120m at full width and depth, f32, through
              python -m torch.distributed.run --nproc-per-node 2 -m
              repro_torch.launch.train (gloo on the one card), --batch 16 a
              rank from the DataPipeline, lr 1e-5, 10 steps: rank 0's losses within
              1e-4 of one process at --batch 32, the ranks' parameters
              equal, launches and 11 all-reduces per rank per step; its
              step-5 checkpoint resumed by 2 ranks, bit for bit; then 10
              steps at the launcher's lr 3e-3 by 2 ranks (spawned by the
              phase), equal bit for bit to one process forming the
              gradient in the ranks' f32 order with no collective (the
              gap to the plain 32-row step recorded); the step's
              all-reduce waits, exposed sync and device busy per rank
  time        each kernel at its path's shapes against its plain version,
              its bound and a PyTorch call computing the same function
              (SDPA and its backward op, F.cross_entropy; none computes
              SSD or its backward) as a yardstick: device time per call
              (CUDA-graph replay) and time per back-to-back call; gemma3's
              head-dim-256 flash forward and backward (window 1024 and
              none) and paged decode at its serve and train shapes

--against NAME=SOURCE (repeatable) builds SOURCE, another version of the
kernel source of its file name (csrc/<kernel>.cu; e.g. a parent commit's,
from `git show`), and runs phases serve, ssm_serve, train and time with
it swapped in for the checkout's library as well, in the order: each
NAME, the checkout twice, each NAME in reverse, so that a drift of the
machine shows as a difference between one build's two readings.  The checkout's
last run is the phase's record; every run's readings go to "against" in
chiprun_out/chip_smoke.json.  In phase time another build's gate
readings are logged but do not fail the run (a build with a part taken
out, to see what that part costs, is wrong by design).

The last line is the JSON device record; the line before it the card's
name and power limit; before that one JSON line of kernel records, and
before that a one-line summary of the run.
Details go to chiprun_out/chip_smoke.json.  Needs one CUDA device and a
checkout of the repository (it imports src/repro_torch).
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
# The cuda-against-cpu checks run first, while the planted faults' builds
# (started at the lowest CPU priority once the build phase is done) take
# the host: nice or not, they slowed the host-bound serve phases 2-3x
# where they overlapped them (and the build from about 60 s to 193 s when
# started beside it), and no check records a time.  They also run before
# train_cli: launch.train.main leaves the process one intra-op thread (its
# bit-exact resume needs it), which slows their CPU references 3.5x.
# faults runs late, once its builds are done.
PHASES = ("build", "kernels", "path", "gemma_path", "ssm_path", "train_path", "ssm_train_path",
          "gemma_train_path", "ddp_path", "serve", "gemma_serve", "ssm_serve", "train",
          "train_cli", "ssm_train", "gemma_train", "ddp", "faults", "time")
AGAINST_PHASES = ("serve", "ssm_serve", "train", "time")   # the phases --against runs again

# H100 SXM peaks (NVIDIA data sheet, dense): the bounds below use them
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12                      # f32 outside the tensor cores
PEAK_BYTES = 3.35e12
# The f32 flash bodies form each f32 product as six bf16 wgmma products of
# the operands' three bf16 pieces (csrc/hopper.cuh): f32 accuracy costs six
# passes at the bf16 rate, so their bound takes the bf16 peak over six;
# PEAK_F32_FLOPS, the CUDA cores' route, is kept beside it (bound_simt_ms)
PEAK_F32_SPLIT_FLOPS = PEAK_BF16_FLOPS / 6

# kernel vs plain version, per element: f32 |err| <= 2e-5 (the JAX kernel
# tests' bar); bf16 |err| <= u * (|want| + want_abs) + 1e-5, u = 2^-8 the
# bf16 unit roundoff and want_abs the plain version with |v| in place of
# v.  Rounding the output costs at most u * |want|, and rounding the
# softmax weights P to bf16 before P.V (the flash kernel's tensor-core
# body) at most u * sum(p |v|) / l = u * want_abs; f32 accumulation is far
# below both.  A limit that follows each element holds small outputs (late
# rows of a long causal row, ~0.05) as tightly as large ones.
F32_TOL = 2e-5
BF16_U, BF16_ATOL = 2.0**-8, 1e-5
OLD_BF16_TOL = 2e-2                         # the former flat bf16 limit, for the fault readings
PATH_REL_TOL = 1e-4                         # max |cuda - cpu| / max |cpu|
# fused_xent, per element |err| <= atol + rtol |want|: the forward's nll
# is f32 arithmetic on exactly representable inputs in both dtypes, so
# both take the JAX fused_xent tests' 1e-4; the backward in f32 takes the
# JAX softmax-identity test's 1e-5, and in bf16 one rounding of the f32
# result (2^-8 |want|) plus the f32 bar's relative 1e-5 for the lse the
# kernel's own forward wrote.
XENT_FWD_TOL = (1e-4, 1e-4)
XENT_BWD_TOL = (1e-5, 1e-5)
# ssd_scan, per element: |err| <= u_out |want| + (SSD_REL + 8 eps |acs|max
# + u_ops) want_abs + 1e-6, want_abs the plain version with |x|, |B|, |C|
# (the sum of the terms' absolute values; decays and dt are positive).
# SSD_REL covers f32 sums taken in another order; the decay exponents acs_l
# - acs_s come from an f32 cumsum of dt A, which in any order carries about
# eps |acs| of error, the largest |acs| being a chunk's whole sum
# (measured on the CPU against f64: at most 1.1 eps |acs|max of want_abs).
# u_out = 2^-8 for a bf16 y (one rounding of the f32 result), 0 for f32 y
# and for the f32 state.  u_ops: the roundings of the bf16 body of three
# passes (kernels/ssd_scan.py:wgmma_body), 0 where another body runs:
#   - SSD_U_OPERAND = 2^-8, y only: the mapped scores C B^T o exp(acs_l -
#     acs_s) o dt_s and the carried state, each rounded to bf16 as a wgmma
#     operand, move y by at most 2^-8 of the intra-chunk and of the
#     inter-chunk part of want_abs;
#   - SSD_U_SPLIT = 2^-16, the state and y: the state update's w x enters
#     its product as two bf16 terms hi + lo, whose sum is within 2^-16 of
#     w x, so each chunk's update, and the states it carries into y, by at
#     most 2^-16 of their part of want_abs.
SSD_REL, F32_EPS = 1e-6, 2.0**-24
SSD_U_OPERAND, SSD_U_SPLIT = 2.0**-8, 2.0**-16
# ssd_scan's backward, per element of each gradient (dx, ddt, dA, dB, dC)
# against the autograd of the plain ssd_ref on the f32 values: |err| <=
# SSD_BWD_REL max|want| + SSD_BWD_ATOL, the JAX ssd tests' 1e-4 taken of the
# gradient's scale (its sums run over whole chunks, in another order); in
# bf16 plus u |want| on dx, dB and dC, u = 2^-8: the kernel reads the bf16
# inputs exactly and computes in f32, so its one rounding is the output's
# (ddt and dA go out in f32)
SSD_BWD_REL, SSD_BWD_ATOL = 1e-4, 1e-6


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {time.perf_counter() - T_START:7.1f}s {msg}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------

# gemma3-4b's attention (B, S, H, Hkv, D, causal): a serve prefill at S
# 2048, and the gemma_train phase's B 4 x S 2048
GEMMA_WINDOW = 1024                        # gemma3-4b's local layers
GEMMA_SERVE_ATTN = (1, 2048, 8, 4, 256, True)
GEMMA_TRAIN_ATTN = (4, 2048, 8, 4, 256, True)

FLASH_CASES = [  # (B, S, H, Hkv, D, causal, window, softcap)
    (2, 256, 4, 4, 64, True, None, 0.0),       # rep 1
    (1, 300, 8, 2, 128, True, None, 0.0),      # rep 4, ragged S
    (1, 1024, 24, 2, 128, True, None, 0.0),    # rep 12, the serving shape
    (2, 200, 12, 1, 128, False, None, 0.0),    # non-causal, rep 12, ragged
    (1, 512, 8, 2, 64, True, 100, 0.0),        # sliding window
    (1, 384, 4, 1, 128, True, None, 30.0),     # softcap
    (1, 129, 4, 4, 64, False, 64, 20.0),       # non-causal window + softcap
    (1, 2048, 24, 2, 128, True, None, 0.0),    # S = 2048
    # the bf16 body's tile edges: 128 q rows a block, 64 (D 64) or 128 keys a tile
    (2, 1, 4, 2, 64, True, None, 0.0),         # S = 1
    (1, 1, 8, 2, 128, False, None, 0.0),
    (2, 127, 4, 1, 64, False, None, 0.0),      # a key short of a tile
    (1, 127, 12, 1, 128, True, None, 0.0),
    (2, 129, 4, 4, 64, True, None, 0.0),       # a key past a tile
    (1, 129, 24, 2, 128, False, None, 30.0),
    (1, 640, 8, 2, 128, True, 200, 0.0),       # a window of 200 crosses 128-key tiles
    (2, 600, 4, 4, 64, False, 200, 0.0),
    # head dim 256 (gemma3-4b: 8 q / 4 kv heads): the serve prefill at S
    # 2048 (a local layer's window 1024, and a global layer), the train
    # shape B 4 x S 2048, and the D-256 bodies' edges (bf16: 128 q rows a
    # block, 64-key tiles; f32: 64 rows a block, 16-key tiles)
    GEMMA_SERVE_ATTN + (GEMMA_WINDOW, 0.0), GEMMA_SERVE_ATTN + (None, 0.0),
    GEMMA_TRAIN_ATTN + (GEMMA_WINDOW, 0.0), GEMMA_TRAIN_ATTN + (None, 0.0),
    (2, 1, 8, 4, 256, True, None, 0.0),
    (2, 129, 8, 4, 256, True, 40, 0.0),
    (1, 65, 8, 4, 256, False, None, 0.0),
    (1, 300, 8, 4, 256, False, 100, 20.0),      # non-causal window + softcap
]

PAGED_CASES = [  # (B, H, Hkv, D, P, NP, maxp, window, softcap, (pos lo, hi))
    (8, 24, 2, 128, 16, 160, 16, None, 0.0, (0, 255)),     # rep 12, short tables
    (8, 24, 2, 128, 16, 160, 16, 100, 0.0, (0, 255)),      # window
    (8, 24, 2, 128, 16, 160, 16, None, 30.0, (0, 255)),    # softcap
    (4, 8, 2, 64, 8, 64, 12, None, 0.0, (0, 95)),          # rep 4, D 64, page 8
    # the serve phase's decode tick: 128-page tables, prompts of 65-1024
    # plus 32 new tokens, so up to 17 live splits of 64 keys for the combine
    (8, 24, 2, 128, 16, 512, 128, None, 0.0, (65, 1055)),
    (8, 24, 2, 128, 16, 512, 128, 300, 0.0, (65, 1055)),   # window: splits past 0
    # the bf16 wgmma body's edges (64-key splits of one stage, pages stacked
    # into 64 rows; position 0 and a table live to its last column above)
    (6, 2, 2, 128, 16, 80, 16, None, 0.0, (0, 255)),       # rep 1
    (6, 32, 2, 128, 16, 80, 16, None, 0.0, (0, 255)),      # rep 16
    (6, 8, 2, 64, 16, 80, 16, None, 0.0, (0, 255)),        # D 64 at P 16
    (6, 24, 2, 128, 32, 80, 16, None, 0.0, (0, 511)),      # D 128 at P 32
    (6, 24, 2, 128, 64, 40, 8, None, 0.0, (0, 511)),       # P 64: a page a stage
    (16, 24, 2, 128, 16, 128, 8, None, 0.0, (63, 65)),     # positions at a stage's edge
    (8, 24, 2, 128, 16, 160, 16, 5, 0.0, (0, 255)),        # a window inside a page
    (6, 24, 2, 128, 16, 160, 32, 200, 0.0, (300, 500)),    # a window from inside a later split
    (8, 24, 2, 128, 16, 160, 16, 40, 30.0, (0, 255)),      # window and softcap
    # head dim 256 (gemma3-4b's global layers, rep 2): 8 slots of about 2000
    # tokens, page 16; a window; short tables
    (8, 8, 4, 256, 16, 1100, 136, None, 0.0, (1800, 2100)),
    (8, 8, 4, 256, 16, 600, 64, 100, 0.0, (0, 1000)),
    (6, 8, 4, 256, 16, 80, 16, None, 0.0, (0, 255)),
]


# bert-mlm-120m's attention at the train phases' batch 32 x 512: the shape
# the train and train_cli phases give the flash forward and backward
BERT_ATTN = (32, 512, 12, 12, 64, False)
# phase time's windowed flash backward below D 256, {head dim: window}:
# bert's shape made causal at D 64, starcoder2-3b's GQA shape at D 128
WINDOW_TIMED = {64: 128, 128: 200}

# the backward kernel: (B, S, H, Hkv, D, causal[, window]); no softcap yet
FLASH_BWD_CASES = [
    (2, 256, 4, 4, 64, True),       # rep 1, causal
    (1, 300, 8, 2, 128, True),      # rep 4, D 128, ragged S
    (2, 200, 12, 1, 64, False),     # rep 12, non-causal, ragged
    (1, 77, 6, 2, 64, False),       # one ragged tile and a half
    BERT_ATTN,
    # the bf16 body's tile edges (64-row tiles, 128 rows or keys a block):
    # at each S, D 64 and 128, causal and not, rep 1 and 4
    *[(2, S, 2 * rep, 2, D, causal) for S in (63, 64, 65, 127, 129, 511, 513)
      for D, causal, rep in ((64, True, 1), (128, False, 4), (64, False, 4), (128, True, 1))],
    # the f32 body's at D 128 (32-row q tiles in dkdv, 32-key tiles in dq)
    (2, 31, 8, 2, 128, True), (2, 33, 2, 2, 128, False), (1, 97, 8, 2, 128, True),
    # a sliding window at D 64 and 128: edges inside and across the tiles,
    # causal and not, GQA, ragged S
    (2, 600, 8, 2, 64, True, 200), (1, 513, 8, 2, 128, True, 100),
    (2, 300, 4, 4, 64, False, 64), (1, 700, 8, 2, 128, True, 65),
    (2, 333, 8, 2, 128, True, 50), (2, 129, 4, 4, 64, True, 1),
    (1, 200, 6, 2, 128, False, 33),
    # head dim 256 (bf16: one warpgroup, 32-key and 32-row tiles, dK and
    # dV in two halves; f32: one warpgroup, the resident tile in f32,
    # 16-key and 16-row tiles, dQ, dK and dV in two halves): gemma3's train
    # shape with its window and without, and the tiles' edges
    GEMMA_TRAIN_ATTN + (GEMMA_WINDOW,), GEMMA_TRAIN_ATTN,
    (2, 77, 8, 4, 256, False), (1, 130, 8, 4, 256, True, 40), (2, 33, 8, 2, 256, False, 16),
    (2, 96, 8, 4, 256, True), (1, 200, 4, 4, 256, False, 70),
]

XENT_CASES = [  # (T, V)
    (3904, 32768),   # one loss chunk of the train phase: 32 x 122 rows
    (37, 1000),      # a ragged last tile
    (5, 1001),       # V odd: the scalar loads
    (300, 4099),     # one column past a tile
    (64, 50),        # less than one tile
]

# (B, S, H, P, G, N, chunk, scale of A, C tied to B).  Each case runs in
# both dtypes.  The last one is sharp: with |A| at most 0.01 the chunks'
# |cumsum(dt A)| stays near 2, so the f32 limit is about 2e-6 of want_abs
# (1e-4 at scale 1), and with C equal to B the score of a step with itself
# is the sum of its absolute terms: the first rows of the first chunk,
# whose y has a term or two, are held to 2e-6 of those terms (with B and
# C drawn apart their scores cancel to about a seventh of want_abs, and
# map(S) on two pieces passes at 0.5-0.8 of the limit; the CPU emulation,
# tests/test_torch_ssd_split.py)
SSD_CASES = [
    (1, 1024, 24, 64, 1, 128, 256, 1.0, False),    # mamba2-130m's prefill at S = 1024
    (1, 321, 24, 64, 1, 128, 256, 1.0, False),     # a full chunk and a ragged one of 65
    (1, 65, 24, 64, 1, 128, 256, 1.0, False),      # the shortest serve prompt: one partial chunk
    (2, 300, 8, 16, 2, 16, 32, 1.0, False),        # the reduced shapes, G = 2, ragged
    (2, 200, 8, 32, 4, 64, 64, 1.0, False),        # G = 4, the 64-row tiles at chunk 64
    (2, 250, 6, 16, 3, 8, 96, 1.0, False),         # chunk 96 (32-row tiles past the first), N 8
    (1, 600, 4, 64, 1, 128, 256, 50.0, False),     # decays past f32's exp range above the diagonal
    # the three-pass bodies' edges (64-row tiles, 64-step key tiles, chunks of 64-256)
    (1, 1024, 80, 64, 1, 64, 256, 1.0, False),     # zamba2-2.7b's N 64 at H 80
    (2, 700, 8, 64, 2, 128, 256, 1.0, False),      # B 2, G 2, S ragged inside a 64-row tile
    (1, 40, 24, 64, 1, 128, 256, 1.0, False),      # S < 64: one partial tile
    (1, 512, 24, 64, 1, 128, 256, 1.0, False),     # S an exact multiple of the chunk
    (2, 200, 8, 64, 4, 64, 64, 1.0, False),        # chunk 64: one tile a chunk, G 4
    (1, 333, 6, 64, 3, 128, 128, 1.0, False),      # chunk 128, G 3
    (1, 450, 4, 64, 2, 64, 192, 1.0, False),       # chunk 192
    (1, 1024, 24, 64, 1, 128, 256, 0.01, True),    # mamba2-130m's prefill, sharp (see above)
]


# mamba2-130m's SSD scan in the ssm_train phase: (B, S, H, P, G, N, chunk)
MAMBA2_TRAIN = (16, 1024, 24, 64, 1, 128, 256)

SSD_BWD_CASES = [  # (B, S, H, P, G, N, chunk, a non-zero gstate)
    (*MAMBA2_TRAIN, False),                 # the train shape; train mode's zero gstate
    (2, 1000, 24, 64, 1, 128, 256, False),  # S ragged inside the last chunk
    (2, 700, 8, 64, 2, 128, 256, True),     # G 2 at H 8, a non-zero gstate; S ragged in a tile
    (1, 100, 24, 64, 1, 128, 256, True),    # S < chunk
    (2, 300, 8, 16, 2, 16, 32, True),       # the reduced shapes: P 16, chunk 32
    (2, 250, 6, 32, 3, 8, 96, True),        # chunk 96 (32-row tiles), P 32, N 8, G 3
    # the wgmma body's edges (64-row tiles, chunks of 64-256, N 64 and 128)
    (1, 1024, 80, 64, 1, 64, 256, False),   # zamba2-2.7b's N 64 at H 80
    (2, 200, 8, 64, 4, 64, 64, True),       # chunk 64: one tile a chunk, G 4
    (1, 333, 6, 64, 3, 128, 128, True),     # chunk 128, G 3, S ragged inside a tile
    (1, 450, 4, 64, 2, 64, 192, False),     # chunk 192, G 2
    (1, 40, 24, 64, 1, 128, 256, True),     # S < 64: one partial tile
]


def _flash_inputs(torch, case, dtype, gen):
    B, S, H, Hkv, D, *_ = case
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return mk(B, S, H, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)


def paged_tables(torch, case):
    """The case's tables and positions, on the CPU: fragmented tables;
    positions in the case's range, the first two active slots at its ends;
    up to two allocated pages past each position (as the engine allocates
    for max_new) and trash page 0 past each allocation; two inactive slots
    (all-zero tables, stale positions; one past the table, by less than a
    window, so that its row keeps a live key)."""
    B, _, _, _, P, NP, maxp, window, _, (lo, hi) = case
    perm = (torch.randperm(NP - 1, generator=torch.Generator().manual_seed(1)) + 1).tolist()
    tables = torch.zeros((B, maxp), dtype=torch.int32)
    pos = torch.zeros((B,), dtype=torch.int32)
    lens_rng = torch.Generator().manual_seed(2)
    for b in range(B - 2):
        p = (lo, hi)[b] if b < 2 else int(torch.randint(lo, hi + 1, (1,), generator=lens_rng))
        n = min(maxp, p // P + 1 + int(torch.randint(0, 3, (1,), generator=lens_rng)))
        pages, perm = perm[:n], perm[n:]
        tables[b, :n] = torch.tensor(pages, dtype=torch.int32)
        pos[b] = p
    pos[B - 2] = 3 * P + 5                # inactive: stale position
    pos[B - 1] = maxp * P + (7 if window is None else min(7, window - 2))   # past the table
    return tables, pos


def _paged_inputs(torch, case, dtype, gen):
    B, H, Hkv, D, P, NP, *_ = case
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    q, kp, vp = mk(B, H, D), mk(NP, P, Hkv, D), mk(NP, P, Hkv, D)
    tables, pos = paged_tables(torch, case)
    return q, kp, vp, tables.cuda(), pos.cuda()


def gate(torch, got, want, want_abs, dname):
    """(max abs error, max of error / limit): the kernel passes at <= 1."""
    err = (got.float() - want).abs()
    if dname == "float32":
        return err.max().item(), err.max().item() / F32_TOL
    lim = BF16_U * (want.abs() + want_abs) + BF16_ATOL
    return err.max().item(), (err / lim).max().item()


def flash_reading(torch, q, k, v, causal, window=None, softcap=0.0):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    got = flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap)
    q, k, v = q.float(), k.float(), v.float()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    want_abs = ref.flash_attention_ref(q, k, v.abs(), causal=causal, window=window,
                                       softcap=softcap)
    return gate(torch, got, want, want_abs, str(got.dtype).split(".")[1])


def paged_reading(torch, q, kp, vp, tables, pos, window=None, softcap=0.0):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_fwd

    got = paged_attention_fwd(q, kp, vp, tables, pos, window=window, softcap=softcap)
    q, kp, vp = q.float(), kp.float(), vp.float()
    want = ref.paged_attention_ref(q, kp, vp, tables, pos, window=window, softcap=softcap)
    want_abs = ref.paged_attention_ref(q, kp, vp.abs(), tables, pos, window=window,
                                       softcap=softcap)
    return gate(torch, got, want, want_abs, str(got.dtype).split(".")[1])


def _plain_grads(torch, fn, inputs, grad):
    """The plain version's autograd: d fn(*inputs) . grad, in f32."""
    xs = [x.detach().float().requires_grad_(True) for x in inputs]
    with torch.enable_grad():
        out = fn(*xs)
    return out.detach(), torch.autograd.grad(out, xs, grad.float())


def hidden_mask(torch, S, causal, window, device):
    """The (query, key) pairs that attention hides, True where hidden, as
    (S, S) bool: keys after the query when causal, and keys at or before
    query - window with a window.  ``attn_pairs`` counts its complement."""
    i = torch.arange(S, device=device)
    hide = torch.zeros(S, S, dtype=torch.bool, device=device)
    if causal:
        hide |= i[None, :] > i[:, None]
    if window is not None:
        hide |= i[None, :] <= i[:, None] - window
    return hide


def _attention_grads64(torch, q, k, v, do, causal, window):
    """dq, dk, dv of the plain version's function (softmax attention,
    masked, scale D^-1/2) computed in f64 throughout, on the f32 inputs:
    the f32 backward gate's reference.  The plain version itself takes its
    scores in f32, and at head dim 256 and S 2048 its own f32 rounding
    exceeds the 2e-5 bar (phase time records it beside the kernel's as
    ``plain_f32_err_vs_f64``; PERF.md §6); against this reference the
    gate reads the kernel's error alone."""
    xs = [x.detach().double().requires_grad_(True) for x in (q, k, v)]
    S, rep = q.shape[1], q.shape[2] // k.shape[2]
    with torch.enable_grad():
        kr, vr = (x.repeat_interleave(rep, 2) for x in xs[1:])
        s = torch.einsum("bqhd,bkhd->bhqk", xs[0], kr) * q.shape[3]**-0.5
        hide = hidden_mask(torch, S, causal, window, q.device)
        p = torch.softmax(s.masked_fill(hide, -math.inf), -1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    return torch.autograd.grad(out, xs, do.double())


def flash_bwd_reading(torch, q, k, v, do, causal, window=None):
    """The backward kernel (fed the forward kernel's o and lse) against
    the autograd of the plain version on the f32 inputs (f32 kernels: the
    same function in f64, ``_attention_grads64``).  bf16 limit per
    element: u (|want| + want_abs) + 1e-5 with u = 2^-8.  The kernel
    recomputes S and dP exactly (bf16 products, f32 sums) and P in f32
    from the forward's f32 lse; the bf16 roundings it makes are
      - its outputs: u |want|;
      - P and dS as operands of dV = P^T dO, dK = dS^T q, dQ = dS K:
        u P^T |dO|, u scale |dS|^T |q|, u scale |dS| |K|;
      - the forward's output O inside Delta = rowsum(dO O): with the
        forward's gate |O~ - O| <= u (|O| + P|V|), Delta is off by at
        most u Dabs, Dabs = rowsum(|dO| (|O| + P|V|)), so dS by u P Dabs,
        which adds u scale (P Dabs) |K| to dq and u scale (P Dabs)^T |q|
        to dk.
    want_abs sums those terms for each output (over the rep query heads
    of a kv head for dk and dv)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    dname = str(q.dtype).split(".")[1]
    if dname == "float32":
        want = _attention_grads64(torch, q, k, v, do, causal, window)
        return max((gate(torch, g, w, None, dname) for g, w in zip(got, want)),
                   key=lambda r: r[1])
    fn = lambda q_, k_, v_: ref.flash_attention_ref(q_, k_, v_, causal=causal, window=window)
    _, want = _plain_grads(torch, fn, (q, k, v), do)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep_ = H // Hkv
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))   # (B,h,S,D)
    kf, vf = (x.repeat_interleave(rep_, dim=1) for x in (kf, vf))
    s = (qf @ kf.transpose(-1, -2)) * D**-0.5
    hide = hidden_mask(torch, S, causal, window, q.device)
    s = s.masked_fill(hide, ref.NEG_INF)
    del hide
    p = torch.softmax(s, dim=-1)                                  # (B,H,S,S)
    o = p @ vf
    dabs = (dof.abs() * (o.abs() + p @ vf.abs())).sum(-1, keepdim=True)   # (B,H,S,1)
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * o).sum(-1, keepdim=True))
    w = p * dabs + ds.abs()
    dq_abs = (w @ kf.abs()) * D**-0.5
    kv_sum = lambda x: x.unflatten(1, (Hkv, rep_)).sum(2).transpose(1, 2)
    dk_abs = kv_sum((w.transpose(-1, -2) @ qf.abs()) * D**-0.5)
    dv_abs = kv_sum(p.transpose(-1, -2) @ dof.abs())
    abs_terms = (dq_abs.transpose(1, 2), dk_abs, dv_abs)
    return max((gate(torch, g, w, a, dname) for g, w, a in zip(got, want, abs_terms)),
               key=lambda r: r[1])


def _xent_inputs(torch, case, dtype, gen):
    T, V = case
    logits = (3 * torch.randn(T, V, generator=gen, device="cuda")).to(dtype)
    labels = torch.randint(0, V, (T,), generator=gen, device="cuda")
    labels[-1] = V - 1                       # the last column, in the last tile
    g = torch.randn(T, generator=gen, device="cuda")
    return logits, labels, g


def _allclose_gate(torch, got, want, atol, rtol, extra_rel=0.0):
    err = (got.float() - want).abs()
    lim = atol + (rtol + extra_rel) * want.abs()
    return err.max().item(), (err / lim).max().item()


def xent_readings(torch, logits, labels, g):
    """(forward reading, backward reading) of fused_xent against the
    plain version and its autograd on the f32 logits (see XENT_*_TOL)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_xent import fused_xent_bwd, fused_xent_fwd

    nll, lse = fused_xent_fwd(logits, labels)
    dx = fused_xent_bwd(logits, labels, lse, g)
    want, (dwant,) = _plain_grads(torch, lambda x: ref.xent_ref(x, labels), (logits,), g)
    fwd = _allclose_gate(torch, nll, want, *XENT_FWD_TOL)
    if logits.dtype == torch.float32:
        bwd = _allclose_gate(torch, dx, dwant, *XENT_BWD_TOL)
    else:
        bwd = _allclose_gate(torch, dx, dwant, 1e-12, XENT_BWD_TOL[1], extra_rel=BF16_U)
    return fwd, bwd


def _ssd_inputs(torch, case, dtype, gen):
    """x, B, C normal in ``dtype`` (C equal to B where the case ties
    them); dt softplus of a normal; A < 0 with |A| log-uniform in [0.01,
    1] times the case's scale, so some heads carry their state across
    chunks and some forget within a few steps."""
    B, S, H, P, G, N, _, scale, tied = case
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    u = torch.rand(H, generator=gen, device="cuda")
    A = -torch.exp(math.log(0.01) * u) * scale
    dt = torch.nn.functional.softplus(mk(B, S, H))
    x, Bm, Cm = mk(B, S, H, P).to(dtype), mk(B, S, G, N).to(dtype), mk(B, S, G, N).to(dtype)
    return x, dt, A, Bm, Bm.clone() if tied else Cm


def ssd_limits(torch, x, dt, A, N, chunk):
    """(u_out, y's factor of want_abs, the state's factor of want_abs) of
    the ssd_scan gate (see SSD_REL) for a call on these inputs.  The bf16
    body's terms only where it runs: the f32 body on three bf16 pieces
    adds no bf16 rounding, and f32 calls keep the f32 gate."""
    from repro_torch.kernels.ssd_scan import wgmma_body

    S = x.shape[1]
    a = torch.nn.functional.pad(dt * A, (0, 0, 0, (-S) % chunk))
    acs_max = a.unflatten(1, (-1, chunk)).abs().sum(2).max().item()
    rel = SSD_REL + 8 * F32_EPS * acs_max
    u_out = BF16_U if x.dtype == torch.bfloat16 else 0.0
    if wgmma_body(x.dtype, x.shape[3], N, chunk):
        return u_out, rel + SSD_U_OPERAND + SSD_U_SPLIT, rel + SSD_U_SPLIT
    return u_out, rel, rel


def ssd_reading(torch, x, dt, A, Bm, Cm, chunk):
    """The kernel's y and final state against the plain version on the
    f32 values, per element under the SSD_REL limit; the worst of both."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd

    y, st = ssd_scan_fwd(x, dt, A, Bm, Cm, chunk)
    f = [t.float() for t in (x, Bm, Cm)]
    want = ref.ssd_ref(f[0], dt, A, f[1], f[2], chunk)
    want_abs = ref.ssd_ref(f[0].abs(), dt, A, f[1].abs(), f[2].abs(), chunk)
    u_out, rel_y, rel_st = ssd_limits(torch, x, dt, A, Bm.shape[3], chunk)
    out = []
    for got, w, wa, uu, rel in ((y, want[0], want_abs[0], u_out, rel_y),
                                (st, want[1], want_abs[1], 0.0, rel_st)):
        err = (got.float() - w).abs()
        out.append((err.max().item(), (err / (uu * w.abs() + rel * wa + 1e-6)).max().item()))
    return max(out, key=lambda r: r[1])


def _ssd_bwd_inputs(torch, case, dtype, gen):
    """The scan's inputs (``_ssd_inputs``, A at scale 1), gy in ``dtype``
    and an f32 gstate, normal or (train mode) zero."""
    B, S, H, P, G, N, chunk, nonzero = case
    ins = _ssd_inputs(torch, (B, S, H, P, G, N, chunk, 1.0, False), dtype, gen)
    gy = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dtype)
    gstate = torch.randn(B, H, N, P, generator=gen, device="cuda")
    return (*ins, gy, gstate if nonzero else torch.zeros_like(gstate))


def ssd_bwd_reading(torch, x, dt, A, Bm, Cm, gy, gstate, chunk):
    """The backward kernel's five gradients against the autograd of the
    plain ssd_ref on the f32 values (see SSD_BWD_REL); the worst."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    got = ssd_scan_bwd(x, dt, A, Bm, Cm, gy, gstate, chunk)
    xs = [t.detach().float().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    with torch.enable_grad():
        outs = ref.ssd_ref(*xs, chunk)
    want = torch.autograd.grad(outs, xs, (gy.float(), gstate.float()))
    u = BF16_U if x.dtype == torch.bfloat16 else 0.0
    out = []
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        err = (g.float() - w).abs()
        lim = (u if name in ("dx", "dB", "dC") else 0.0) * w.abs() \
            + SSD_BWD_REL * w.abs().max() + SSD_BWD_ATOL
        out.append((err.max().item(), (err / lim).max().item()))
    return max(out, key=lambda r: r[1])


def kernel_readings(torch, dname, only=None):
    """(kernel, case, max abs error, error / limit) for every case, on
    inputs drawn from one seed; ``only``: the kernels to read."""
    dtype = getattr(torch, dname)
    want = lambda *names: only is None or any(n in only for n in names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    if want("flash_attention"):
        for case in FLASH_CASES:
            causal, window, cap = case[5:]
            out.append(("flash_attention", case, *flash_reading(
                torch, *_flash_inputs(torch, case, dtype, gen), causal, window, cap)))
    if want("paged_attention"):
        for case in PAGED_CASES:
            window, cap = case[7:9]
            out.append(("paged_attention", case, *paged_reading(
                torch, *_paged_inputs(torch, case, dtype, gen), window, cap)))
    if want("flash_attention_bwd"):
        for case in FLASH_BWD_CASES:
            B, S, H, Hkv, D, causal, *window = case
            q, k, v = _flash_inputs(torch, (B, S, H, Hkv, D), dtype, gen)
            do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
            if case == BERT_ATTN and want("flash_attention"):    # its forward too
                out.append(("flash_attention", case, *flash_reading(torch, q, k, v, causal)))
            out.append(("flash_attention_bwd", case, *flash_bwd_reading(
                torch, q, k, v, do, causal, window[0] if window else None)))
            del q, k, v, do
    if want("fused_xent", "fused_xent_bwd"):
        for case in XENT_CASES:
            fwd, bwd = xent_readings(torch, *_xent_inputs(torch, case, dtype, gen))
            out.append(("fused_xent", case, *fwd))
            out.append(("fused_xent_bwd", case, *bwd))
    if want("ssd_scan"):
        for case in SSD_CASES:
            out.append(("ssd_scan", case, *ssd_reading(
                torch, *_ssd_inputs(torch, case, dtype, gen), case[6])))
    if want("ssd_scan_bwd"):
        for case in SSD_BWD_CASES:
            out.append(("ssd_scan_bwd", case, *ssd_bwd_reading(
                torch, *_ssd_bwd_inputs(torch, case, dtype, gen), case[6])))
    return out


def check_kernels(torch, rec):
    errs = {name: {} for name in KERNELS}
    for dname in ("float32", "bfloat16"):
        for name, case, err, ratio in kernel_readings(torch, dname):
            log(f"{name} {dname} {case}: max_abs_err {err:.3e}, error/limit {ratio:.3f}")
            if not ratio <= 1.0:
                fail(f"{name} {dname} {case}: error {err} is {ratio:.3f} x its limit")
            e = errs[name].setdefault(dname, {"max_abs_err": 0.0, "max_ratio": 0.0})
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["max_ratio"] = max(e["max_ratio"], ratio)
    rec["errors"] = errs


# planted faults: (source in csrc/, the kernels it serves, the bug, source
# text, its replacement, the dtype of the readings); the gate of one of
# those kernels must fail each on at least one case.  The f32 ones keep
# only the first bf16 piece of one operand of each f32 body (the f32 SSD
# forward's map(S): its first two)
F32_PIECES_DROPPED = " if constexpr (NP == 3) w[1] = w[2] = 0;"
F32_THIRD_PIECE_DROPPED = " if constexpr (NP == 3) w[2] = 0;"   # hi + lo left
FAULTS = [
    ("flash_attention", ("flash_attention",),
     "bf16 body drops keys 0-63 of every row that sees more than 512 keys",
     "s[x] = hopper::exp2_approx(s[x] - m[(x >> 1) & 1]);",
     "s[x] = k0 + (x / 4) * 8 + 2 * t < 64 && kt_hi * BK > 512 ? 0.f : "
     "hopper::exp2_approx(s[x] - m[(x >> 1) & 1]);", "bfloat16"),
    ("flash_attention", ("flash_attention",), "f32 body: P enters O += P V as bf16(P) alone",
     "hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);  // P's pieces",
     "hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);"
     + F32_PIECES_DROPPED + "  // P's pieces", "float32"),
    ("paged_attention", ("paged_attention",),
     "combine merges at most 8 splits (the first 512 keys at P 16 in bf16)",
     "s1 = j_hi / p.pps;", "s1 = min(j_hi / p.pps, s0 + 7);", "bfloat16"),
    ("paged_attention", ("paged_attention",), "wgmma body: the mask lets in the key after pos",
     "const int key_hi = min(pos, (j1 + 1) * P - 1);",
     "const int key_hi = min(pos + 1, (j1 + 1) * P - 1);", "bfloat16"),
    ("paged_attention", ("paged_attention",),
     "wgmma body: the partial max goes to the combine in base 2",
     "p.part_ml[prow * 2] = m[r] * LN2;  // the combine's natural-log units",
     "p.part_ml[prow * 2] = m[r];  // the combine's natural-log units", "bfloat16"),
    ("fused_xent", ("fused_xent", "fused_xent_bwd"), "forward skips the last vocab tile",
     "for (int c0 = 0; c0 < V; c0 += TILE) {  // vocab tiles, in order",
     "for (int c0 = 0; c0 + TILE < V; c0 += TILE) {  // vocab tiles, in order", "bfloat16"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "dq drops the contribution of k tile 0 when there are more",
     "dp[x] = s[x] * (dp[x] - dl[(x >> 1) & 1]);  // dq: dS = P (dP - Delta)",
     "dp[x] = i == 0 && n_tiles > 1 ? 0.f : s[x] * (dp[x] - dl[(x >> 1) & 1]);  "
     "// dq: dS = P (dP - Delta)", "bfloat16"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "dkdv skips the last rep head of each kv head",
     "const int n_iter = rep * nq;  // the ring runs over rep heads x q tiles",
     "const int n_iter = (rep > 1 ? rep - 1 : rep) * nq;  // the ring runs over rep heads x q tiles",
     "bfloat16"),
    ("flash_attention_bwd", ("flash_attention_bwd",), "f32 dq: dS enters dQ += dS K as bf16(dS) alone",
     "hopper::pack_bf16_pieces<NP>(dp[8 * kc + 2 * e], dp[8 * kc + 2 * e + 1], w);  // dS's pieces",
     "hopper::pack_bf16_pieces<NP>(dp[8 * kc + 2 * e], dp[8 * kc + 2 * e + 1], w);"
     + F32_PIECES_DROPPED + "  // dS's pieces", "float32"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "f32 dkdv: P^T enters dV += P^T dO as bf16(P^T) alone",
     "hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);  // P^T's pieces",
     "hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);"
     + F32_PIECES_DROPPED + "  // P^T's pieces", "float32"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "dq: the window's edge one key off (key q - W is let in)",
     "const bool behind = p.window > 0 && key <= row - p.window;  // dq: outside the window",
     "const bool behind = p.window > 0 && key < row - p.window;  // dq: outside the window",
     "bfloat16"),
    ("flash_attention", ("flash_attention",),
     "D-256 tiles: S = Q K^T skips the last 64-column box of the head dim",
     "for (int kk = 0; kk < D / 16; ++kk)",
     "for (int kk = 0; kk < (D == 256 ? D / 16 - 4 : D / 16); ++kk)", "bfloat16"),
    ("ssd_scan", ("ssd_scan",), "the state is carried without its exp(acs_L) decay",
     "if (n < N) st[n * PC + tx] = carry * st[n * PC + tx] + acc[i];",
     "if (n < N) st[n * PC + tx] = st[n * PC + tx] + acc[i];", "bfloat16"),
    ("ssd_scan", ("ssd_scan",), "bf16 body: the carry pass drops the chunks' decay",
     "d[k] = dec[(c0 + k) * p.H];  // exp(acs_L) of the chunk",
     "d[k] = 1.f;  // exp(acs_L) of the chunk", "bfloat16"),
    ("ssd_scan", ("ssd_scan",), "bf16 body: the state pass drops the lo half of w x",
     "hopper::wgmma_ss<64, 1, 1>(u[mt], da, hopper::desc_sw128(xl + kk * 2048, BOX, 1024), 1);",
     "// the lo half dropped", "bfloat16"),
    ("ssd_scan", ("ssd_scan",), "bf16 body: the out pass drops exp(acs_l) from C . state",
     "for (int x = 0; x < 32; ++x) y[x] *= expf(acs_row[(x >> 1) & 1]);",
     "for (int x = 0; x < 32; ++x) y[x] *= 1.f;", "bfloat16"),
    ("ssd_scan", ("ssd_scan",), "f32 body: map(S) enters y without its third piece",
     "hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);  // map(S)'s pieces",
     "hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);"
     + F32_THIRD_PIECE_DROPPED + "  // map(S)'s pieces", "float32"),
    ("ssd_scan", ("ssd_scan",), "f32 body: state_in enters C . state_in as bf16(state_in) alone",
     "hopper::pack_bf16_pieces<NP>(e[2 * i], e[2 * i + 1], w);  // state_in's pieces",
     "hopper::pack_bf16_pieces<NP>(e[2 * i], e[2 * i + 1], w);" + F32_PIECES_DROPPED
     + "  // state_in's pieces", "float32"),
    ("ssd_scan_bwd", ("ssd_scan_bwd",), "backward: the reverse carry drops exp(acs_L)",
     "r = make_float4(fmaf(d, r.x, v.x), fmaf(d, r.y, v.y), fmaf(d, r.z, v.z), fmaf(d, r.w, v.w));",
     "r = make_float4(r.x + v.x, r.y + v.y, r.z + v.z, r.w + v.w);", "bfloat16"),
    ("ssd_scan_bwd", ("ssd_scan_bwd",), "backward: dB skips the last head of its group",
     "for (int r = 0; r < rep; ++r) sb += p.dBh[head0 + r * p.N];  // dB: the group's heads, in order",
     "for (int r = 0; r < rep - 1; ++r) sb += p.dBh[head0 + r * p.N];  // dB: the group's heads, in order",
     "bfloat16"),
    ("ssd_scan_bwd", ("ssd_scan_bwd",),
     "wgmma body's pair pass: M and W enter dx, dB and dC without their lo piece",
     "hopper::pack_bf16_pieces<NPA>(v[8 * kc + 2 * e], v[8 * kc + 2 * e + 1], w);  // M's or W's pieces",
     "hopper::pack_bf16_pieces<NPA>(v[8 * kc + 2 * e], v[8 * kc + 2 * e + 1], w); w[1] = 0;  "
     "// M's or W's pieces", "bfloat16"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "f32 D 256, dkdv's dV block: P^T enters dV += P^T dO as bf16(P^T) alone",
     "hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);  // dV block: P^T's pieces",
     "hopper::pack_bf16_pieces<NP>(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], w);"
     + F32_PIECES_DROPPED + "  // dV block: P^T's pieces", "float32"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "f32 D 256: the resident tile enters S and dP (dq) and S^T and dP^T (the dK block) as bf16 alone",
     "hopper::pack_bf16_pieces<NP>(v.x, v.y, w);  // the resident tile's pieces",
     "hopper::pack_bf16_pieces<NP>(v.x, v.y, w);" + F32_PIECES_DROPPED
     + "  // the resident tile's pieces", "float32"),
]
KERNELS = ("flash_attention", "flash_attention_bwd", "paged_attention", "fused_xent",
           "fused_xent_bwd", "ssd_scan", "ssd_scan_bwd")


def _start_nvcc(src, lib, nice=False):
    """nvcc for ``src`` into ``lib``; ``nice``: at the lowest CPU priority."""
    from repro_torch.kernels import _build

    return subprocess.Popen((["nice", "-n", "19"] if nice else []) + _build.nvcc_command(src, lib),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def start_fault_builds():
    """Write the faulty sources under build/kernels/faults/ and start one
    nvcc for each, at the lowest CPU priority (the phases before phase
    faults keep the cores they need; call it once the build phase is
    done, which these builds would slow); returns {index in FAULTS:
    (process, library path)}."""
    from repro_torch.kernels import _build

    d = _build.BUILD_DIR / "faults"
    d.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, _, _, old, new, _) in enumerate(FAULTS):
        text = (_build.CSRC / f"{name}.cu").read_text()
        if text.count(old) != 1:
            fail(f"faults: {name}.cu does not hold {old!r} once; update FAULTS")
        src, lib = d / f"{name}-{i}.cu", d / f"lib{name}-{i}.so"
        src.write_text(text.replace(old, new))
        procs[i] = (_start_nvcc(src, lib, nice=True), lib)
    return procs


def check_faults(torch, rec, procs):
    import ctypes

    from repro_torch.kernels import _build

    res = []
    for i, (name, kernels, bug, _, _, dname) in enumerate(FAULTS):
        proc, lib = procs[i]
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"faults: the faulty {name} did not build:\n{out}")
        good = _build.swap(name, ctypes.CDLL(str(lib)))
        try:
            readings = [r for r in kernel_readings(torch, dname, only=kernels)
                        if r[0] in kernels]
        finally:
            _build.swap(name, good)
        caught = [(case, err, ratio) for _, case, err, ratio in readings if ratio > 1.0]
        old = max(err for _, _, err, _ in readings)
        log(f"faults: {name} {dname} with '{bug}': gate fails {len(caught)} of "
            f"{len(readings)} cases {[c[0] for c in caught]}, max error/limit "
            f"{max(r[3] for r in readings):.2f}; max abs error {old:.3e}"
            + (f" against the former flat {OLD_BF16_TOL}" if dname == "bfloat16" else ""))
        if not caught:
            fail(f"faults: the kernel gate passed {name} with the planted bug '{bug}'")
        finite = lambda x: x if math.isfinite(x) else str(x)   # the record stays JSON
        res.append({"kernel": name, "dtype": dname, "bug": bug, "cases_failed": len(caught),
                    "cases": len(readings), "failed": [list(map(str, c)) for c in caught],
                    "max_ratio": finite(max(r[3] for r in readings)),
                    "max_abs_err": finite(old),
                    "former_flat_gate_fails": old > OLD_BF16_TOL if dname == "bfloat16" else None})
    rec["faults"] = res


def ptxas_report(log):
    """{function: ptxas's lines on its registers and spills} from an nvcc
    log built with ``-Xptxas -v``, and its warnings under "warnings"
    (such as C7520, wgmma serialized)."""
    out, cur = {}, None
    for line in log.splitlines():
        if "warning" in line or "Performance Loss" in line:
            out.setdefault("warnings", []).append(line.strip())
        elif "Function properties for" in line:
            cur = line.split("Function properties for", 1)[1].strip()
        elif cur and ("spill" in line or "Used" in line):
            out.setdefault(cur, []).append(line.strip())
    return out


def parse_sass(text):
    """{kernel function: {instruction: count}} in ``cuobjdump -sass``
    output: HGMMA (wgmma), UTMALDG / UTMASTG (TMA load / store), HMMA
    (mma.sync), each as a whole word.  Counted over each function's text
    at once: a library's SASS runs to millions of lines, which a regular
    expression per line read in tens of seconds."""
    import re

    word = lambda c: c.isalnum() or c == "_"

    def count(op, body):
        n = i = 0
        while (i := body.find(op, i)) >= 0:
            j = i + len(op)
            if (i == 0 or not word(body[i - 1])) and (j == len(body) or not word(body[j])):
                n += 1
            i = j
        return n

    parts = re.split(r"^[ \t]*Function :(.*)$", text, flags=re.M)
    return {fn.strip(): {op: count(op, body) for op in ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")}
            for fn, body in zip(parts[1::2], parts[2::2])}


def sass_counts(lib):
    """``parse_sass`` of a built library."""
    from repro_torch.kernels import _build

    return parse_sass(subprocess.run(
        [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout)


# the product passes that must run on wgmma and TMA alone: the bf16 bodies
# and the f32 flash and SSD bodies on three bf16 pieces; (kernel source, a
# part of each of its functions' names)
WGMMA_FUNCTIONS = (("flash_attention", "flash_fwd_wgmma"), ("flash_attention_bwd", "dq_wgmma"),
                   ("flash_attention_bwd", "dkdv_wgmma"),
                   ("flash_attention", "flash_fwd_f32_wgmma"),
                   ("flash_attention_bwd", "dq_f32_wgmma"),
                   ("flash_attention_bwd", "dkdv_f32_wgmma"), ("ssd_scan", "ssd_state_wgmma"),
                   ("ssd_scan", "ssd_out_wgmma"), ("ssd_scan", "ssd_state_f32_wgmma"),
                   ("ssd_scan", "ssd_out_f32_wgmma"), ("ssd_scan_bwd", "ssd_bwd_state_wgmma"),
                   ("ssd_scan_bwd", "ssd_bwd_pair_wgmma"), ("paged_attention", "paged_wgmma"))


# the sources whose wgmma bodies must keep every array in registers: ptxas
# reports a stack frame of 0 bytes for each (the flash backward's dK and dV
# accumulators at head dim 256 are 64 floats each a thread, sized by a
# template; the SSD backward's pair pass holds dB or dC, dx, two tile
# products and the pieces of M or W; the f32 SSD forward's out pass y, a
# partial, S and map(S)'s three pieces; an array moved to local memory
# would show here)
FRAMELESS_SOURCES = ("flash_attention_bwd", "ssd_scan_bwd", "ssd_scan")


def stack_frame_faults(ptxas):
    """The functions of ``ptxas_report``'s report whose names hold "wgmma"
    and whose stack frame is not 0 bytes."""
    import re

    return [f"{fn}: {line}" for fn, lines in ptxas.items() if "wgmma" in fn
            for line in lines if (m := re.match(r"(\d+) bytes stack frame", line))
            and int(m.group(1))]


def wgmma_route_faults(sass, part):
    """What keeps the functions named by ``part`` in ``parse_sass``'s
    counts off the wgmma and TMA route: none found, or one without HGMMA
    or UTMALDG or with HMMA.  Empty when every one runs on them alone."""
    fns = {k: v for k, v in sass.items() if part in k}
    if not fns:
        return [f"no function named {part}"]
    return [f"{k}: {v}" for k, v in fns.items()
            if v["HGMMA"] == 0 or v["UTMALDG"] == 0 or v["HMMA"]]


def wgmma_build_facts(rec):
    """The flash forward and backward (bf16 and f32), the bf16 SSD body,
    the SSD backward's wgmma body and the bf16 paged body as built: ptxas's report (registers, spill bytes)
    and SASS counts of every instance of ``WGMMA_FUNCTIONS``.  Fails unless
    each runs on HGMMA and UTMALDG with no HMMA, if ptxas serialized a
    wgmma (its warning C7520), or if a wgmma body of
    ``FRAMELESS_SOURCES`` has a stack frame."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    names = list(dict(WGMMA_FUNCTIONS))
    with ThreadPoolExecutor(len(names)) as pool:    # one cuobjdump a library, all at once
        all_sass = dict(zip(names, pool.map(
            lambda n: sass_counts(_build._lib_path(_build.CSRC / f"{n}.cu")), names)))
    facts, faults = {}, []
    for name in names:
        ptxas = rec["ptxas"].get(name, {})
        sass = all_sass[name]
        for _, part in (f for f in WGMMA_FUNCTIONS if f[0] == name):
            for k, v in sass.items():
                if part in k:
                    log(f"{name} {k}: SASS {v}; ptxas {ptxas.get(k, 'not built in this run')}")
            faults += wgmma_route_faults(sass, part)
        faults += [w for w in ptxas.get("warnings", []) if "C7520" in w]
        if name in FRAMELESS_SOURCES:
            faults += stack_frame_faults(ptxas)
        facts[name] = {"ptxas": ptxas, "sass": sass}
    if faults:
        fail(f"the product kernels do not run on wgmma and TMA alone: {faults}")
    rec["flash_fwd_build"] = facts["flash_attention"]
    rec["flash_bwd_build"] = facts["flash_attention_bwd"]
    rec["ssd_build"] = facts["ssd_scan"]
    rec["ssd_bwd_build"] = facts["ssd_scan_bwd"]
    rec["paged_build"] = facts["paged_attention"]


def parse_against(specs):
    """[(name, kernel, source)] of the ``--against NAME=SOURCE`` options:
    SOURCE stands for ``csrc/<kernel>.cu``, ``kernel`` its file's stem."""
    from repro_torch.kernels import _build

    out = []
    for spec in specs:
        name, _, src = spec.partition("=")
        src = Path(src).resolve()
        if not name or name == "checkout" or name in [a[0] for a in out]:
            fail(f"--against {spec!r}: NAME must be new, and not 'checkout'")
        if src.suffix != ".cu" or not src.is_file() or not (_build.CSRC / src.name).is_file():
            fail(f"--against {spec!r}: SOURCE must be a file named after a kernel source "
                 f"in {_build.CSRC}")
        out.append((name, src.stem, src))
    return out


def start_against_builds(against):
    """One nvcc for each ``--against`` source, into build/kernels/against/;
    returns {name: (process, library path)}."""
    from repro_torch.kernels import _build

    d = _build.BUILD_DIR / "against"
    d.mkdir(parents=True, exist_ok=True)
    return {name: (_start_nvcc(src, d / f"lib{kernel}-{name}.so"), d / f"lib{kernel}-{name}.so")
            for name, kernel, src in against}


def load_against(rec, against, procs):
    """{name: (kernel, loaded library)} of the ``--against`` builds, with
    each build's source, ptxas report and SASS counts in ``rec``."""
    import ctypes

    libs, facts = {}, {}
    for name, kernel, src in against:
        proc, lib = procs[name]
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"--against {name}: {src} did not build:\n{out}")
        facts[name] = {"kernel": kernel, "source": str(src), "ptxas": ptxas_report(out),
                       "sass": sass_counts(lib)}
        libs[name] = (kernel, ctypes.CDLL(str(lib)))
        log(f"against {name}: {kernel} from {src}; ptxas warnings "
            f"{facts[name]['ptxas'].get('warnings', [])}")
    rec["against_builds"] = facts
    return libs


def run_against(torch, rec, ph, step, libs):
    """Phase ``ph`` with each ``--against`` build swapped in for its
    kernel's library, and with the checkout's, in the order each build,
    the checkout twice, each build in reverse.  The checkout's last run
    becomes the phase's record; every run's summary and record go to
    ``rec["against"][ph]``."""
    from repro_torch.kernels import _build

    runs = []
    for name in [*libs, "checkout", "checkout", *reversed(libs)]:
        r = {}
        if name == "checkout":
            step(torch, r)
            last = r
        else:
            kernel, lib = libs[name]
            good = _build.swap(kernel, lib)
            try:
                if ph == "time":
                    time_kernels(torch, r, strict=False)
                else:
                    step(torch, r)
            finally:
                _build.swap(kernel, good)
        reading = {k: v for k, v in summary(r).items()
                   if v is not None and (not isinstance(v, dict) or any(
                       x is not None for x in v.values()))}
        log(f"against {ph} {name}: {json.dumps(reading)}")
        runs.append({"build": name, "summary": reading, "record": r})
    rec.update(last)
    rec.setdefault("against", {})[ph] = runs


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def _tap(eng, log_):
    """Record the engine's prefill and decode logits (host copies)."""
    pre, dec = eng._prefill, eng._decode

    def prefill(*a):
        logits, cache = pre(*a)
        log_.append(("prefill", logits[0, -1].float().cpu()))
        return logits, cache

    def decode(params, pools, tokens, positions, tables):
        logits, pools = dec(params, pools, tokens, positions, tables)
        active = tables[:, 0] != 0        # inactive slots read the trash page
        log_.append(("decode", logits[active, 0].float().cpu()))
        return logits, pools

    eng._prefill, eng._decode = prefill, decode


def compare_engines(torch, name, cfg, prompts, max_new, want_launches, engine_kw=None):
    """The paged engine on cuda and on cpu (plain versions) from the same
    f32 weights: each prefill's and decode tick's logits within
    PATH_REL_TOL of the largest cpu logit, the same greedy tokens; the
    cuda run's kernel launches must equal ``want_launches(engine)`` and
    the cpu run must launch none.  ``engine_kw``: the engines' pool
    sizes (default 4 slots of up to 32 pages of 16 tokens)."""
    import copy

    from repro_torch.configs import default_run_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import PagedServeEngine

    run = default_run_config(cfg, ShapeConfig("serve", 0, 0, "decode"))
    model_cpu = build_model(cfg, seed=0, device="cpu")
    model_gpu = copy.deepcopy(model_cpu).to("cuda")   # the same weights
    engine_kw = engine_kw or dict(page=16, n_pages=128, max_slots=4, max_pages=32)
    eng_cpu, eng_gpu = (PagedServeEngine(m, run, **engine_kw) for m in (model_cpu, model_gpu))
    logs, outs = {}, {}
    for dev, eng in (("cpu", eng_cpu), ("cuda", eng_gpu)):
        logs[dev] = []
        _tap(eng, logs[dev])
        ops.reset_launch_counts()
        outs[dev] = serve(eng, prompts, max_new=max_new)
        counts = dict(ops.launch_counts)
        log(f"{name} {dev}: launches {counts}, ticks {eng.decode_ticks}")
        if dev == "cuda" and counts != want_launches(eng):
            fail(f"{name}: the cuda run did not go through the kernels: {counts}, "
                 f"expected {want_launches(eng)}")
        if dev == "cpu" and counts:
            fail(f"{name}: the cpu run launched kernels: {counts}")
    if outs["cpu"] != outs["cuda"]:
        fail(f"{name}: greedy tokens differ: cpu {outs['cpu']} cuda {outs['cuda']}")
    worst = 0.0
    for (kind, a), (_, b) in zip(logs["cpu"], logs["cuda"], strict=True):
        rel = ((a - b).abs().max() / a.abs().max()).item()
        worst = max(worst, rel)
        if not torch.isfinite(b).all() or not rel <= PATH_REL_TOL:
            fail(f"{name}: {kind} logits differ, relative error {rel}")
    log(f"{name}: {len(logs['cpu'])} logit sets agree, max relative error "
        f"{worst:.3e} (tol {PATH_REL_TOL}); tokens equal")
    return {"max_rel_err": worst, "logit_sets": len(logs["cpu"]), "tokens": outs["cuda"],
            "decode_ticks": eng_gpu.decode_ticks}


def check_path(torch, rec):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerSpec, uniform_schedule
    from repro_torch.launch.serve import random_prompts

    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              schedule=uniform_schedule(2, LayerSpec()))
    # a 300-token prompt: 20 pages, three of the paged kernel's 8-page splits
    prompts = random_prompts(2, [300, 37], cfg.vocab_size, seed=1)
    rec["path"] = compare_engines(
        torch, "path", cfg, prompts, 9,
        lambda eng: {"flash_attention": 2 * len(prompts),
                     "paged_attention": 2 * eng.decode_ticks})


def check_ssm_path(torch, rec):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA, LayerSpec, uniform_schedule
    from repro_torch.launch.serve import random_prompts

    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              schedule=uniform_schedule(2, LayerSpec(kind=MAMBA, has_mlp=False)))
    # 300 tokens: a full chunk of 256 carries its state into a ragged one of 44
    prompts = random_prompts(2, [300, 37], cfg.vocab_size, seed=1)
    rec["ssm_path"] = compare_engines(torch, "ssm_path", cfg, prompts, 9,
                                      lambda eng: {"ssd_scan": 2 * len(prompts)})


def gemma_cfg(n_layers):
    """gemma3-4b at full width, its depth cut to ``n_layers``: 2, one
    local layer (window 1024) and one global; 6, the first pattern group
    once (5 local, 1 global); 34, the whole model."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, LayerSpec, ScheduleGroup

    cfg = get_config("gemma3-4b")
    if n_layers == cfg.n_layers:
        return cfg
    local, glob = LayerSpec(kind=ATTN, window=GEMMA_WINDOW), LayerSpec(kind=ATTN)
    pattern = {2: (local, glob), 6: (local,) * 5 + (glob,)}[n_layers]
    return dataclasses.replace(cfg, schedule=(ScheduleGroup(pattern=pattern, repeats=1),))


def check_gemma_path(torch, rec):
    """gemma3-4b at full width, 2 layers (local, global), f32: prompts of
    1500 tokens (past the window: a ragged ring fill under the 2048-token
    bucket) and 37; 9 new tokens, so the long prompt's decode writes over
    its ring's oldest positions.  Every prefill launches the flash kernel
    in both layers (the window in the local one), every tick the paged
    kernel in the global layer only."""
    from repro_torch.launch.serve import random_prompts

    cfg = gemma_cfg(2)
    prompts = random_prompts(2, [1500, 37], cfg.vocab_size, seed=1)
    rec["gemma_path"] = compare_engines(
        torch, "gemma_path", cfg, prompts, 9,
        lambda eng: {"flash_attention": 2 * len(prompts),
                     "paged_attention": global_attn_layers(cfg) * eng.decode_ticks},
        engine_kw=dict(page=16, n_pages=256, max_slots=4, max_pages=128))


def run_gemma_serve(torch, rec):
    """gemma3-4b at full width and depth, bf16: 16 requests with prompts
    uniform in 600-3000 tokens (most past the window), 32 new tokens each,
    8 slots of up to 192 pages of 16 tokens; device busy of a 2048-token
    prefill and of a tick."""
    run_serve(torch, rec, arch="gemma3-4b", key="gemma_serve", lens=(600, 3000),
              n_pages=2048, max_pages=192, prefill_S=2048)


def global_attn_layers(cfg):
    """The attention layers without a sliding window: the ones that decode
    through the paged kernel (a windowed layer decodes over its ring)."""
    from repro_torch.configs.base import ATTN

    return sum(g.repeats * sum(s.kind == ATTN and s.window is None for s in g.pattern)
               for g in cfg.schedule)


def run_serve(torch, rec, seed=0, arch="starcoder2-3b", key="serve", lens=(65, 1024),
              n_pages=1024, max_pages=128, prefill_S=1024):
    """``arch`` at full width and depth in bf16, random weights from
    ``seed``: 16 requests, prompts uniform in ``lens`` tokens, 32 new
    tokens each, all submitted at once; 8 slots, page 16.  Every layer's
    prefill must launch its kernel (flash, or ssd_scan), and every decode
    tick the paged kernel once a global attention layer."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, random_prompts, serve

    cfg = get_config(arch)
    n_req, max_new = 16, 32
    t0 = time.perf_counter()
    eng = build_engine(cfg, device="cuda", dtype="bfloat16", seed=seed, page=16,
                       n_pages=n_pages, max_slots=8, max_pages=max_pages)
    torch.cuda.synchronize()
    log(f"{key}: model + pools built in {time.perf_counter() - t0:.1f}s, "
        f"pools {eng.kv.pool_bytes() / 2**20:.0f} MiB")
    serve(eng, random_prompts(1, [64], cfg.vocab_size, seed + 99), max_new=2)  # warm-up
    lens = np.random.RandomState(seed).randint(lens[0], lens[1] + 1, n_req).tolist()
    prompts = random_prompts(n_req, lens, cfg.vocab_size, seed + 1)
    eng.samples = {k: [] for k in eng.samples}
    ticks0 = eng.decode_ticks
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve(eng, prompts, max_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    ticks = eng.decode_ticks - ticks0
    n_layers = cfg.n_layers
    want = ({"ssd_scan": n_layers * n_req} if cfg.family == "ssm" else
            {"flash_attention": n_layers * n_req,
             "paged_attention": global_attn_layers(cfg) * ticks})
    log(f"{key}: launches {counts}, expected {want}, decode ticks {ticks}")
    if len(out) != n_req or any(len(t) != max_new for t in out.values()):
        fail(f"{key}: {len(out)} of {n_req} requests finished")
    if any(not 0 <= t < cfg.vocab_size for toks in out.values() for t in toks):
        fail(f"{key}: a token id outside the vocabulary")
    if counts != want:
        fail(f"{key}: kernel launches {counts} != {want} ({n_layers} layers, "
             f"{n_req} prefills, {ticks} ticks)")
    res = {"arch": arch, "requests": n_req, "prompt_lens": lens, "max_new": max_new,
           "seconds": dt, "tokens_per_s": n_req * max_new / dt,
           "ttft_p50_ms": float(np.median(eng.samples["ttft_ms"])),
           "decode_tick_p50_ms": float(np.median(eng.samples["decode_tick_ms"])),
           "decode_ticks": ticks, "launches": counts}
    log(f"{key}: {json.dumps({k: v for k, v in res.items() if k != 'prompt_lens'})}")
    rec[key] = res
    rec[f"{key}_prefill_profile"] = profile_prefill(torch, eng, cfg, S=prefill_S)
    rec[f"{key}_decode_profile"] = profile_ticks(torch, eng, cfg, res["decode_tick_p50_ms"])
    del eng
    torch.cuda.empty_cache()


def _by_class(kern, n):
    out = {}
    for e in kern:
        c = _kernel_class(e.key)
        out[c] = out.get(c, 0.0) + e.self_device_time_total / n / 1e3
    return out


def _device_kernels(torch, prof):
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def profile_prefill(torch, eng, cfg, S=1024, n=3):
    """Where one S-token prefill's time goes: ``n`` prefills of the engine
    under torch.profiler; device busy time by class and the top device
    operations against the host clock."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import random_prompts

    toks = torch.tensor(random_prompts(1, [S], cfg.vocab_size, 11), device="cuda")
    eng._prefill(eng.model, toks, S)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng._prefill(eng.model, toks, S)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    kern = _device_kernels(torch, prof)
    busy = sum(e.self_device_time_total for e in kern) / n / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    res = {"tokens": S, "prefill_wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall if busy else None,
           "kernel_launches": sum(e.count for e in kern) / n,
           "ms_by_class": _by_class(kern, n),
           "top": [{"name": e.key[:80], "ms": e.self_device_time_total / n / 1e3,
                    "calls": e.count / n} for e in top]}
    log(f"prefill profile: {json.dumps(res)}")
    return res


def profile_ticks(torch, eng, cfg, tick_p50_ms, n_ticks=4):
    """Where a decode tick's time goes: 8 slots at ~1000 tokens, a few
    ticks under torch.profiler; device busy time by kernel against the
    host clock (the profiler slows the host, so the idle share is also
    given against the unprofiled tick p50)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import random_prompts

    for p in random_prompts(8, [1000], cfg.vocab_size, 7):
        eng.submit(p, n_ticks + 3)
    eng.step()                                  # admit + prefill all 8
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_ticks * 1e3
    eng.serve()
    kern = _device_kernels(torch, prof)
    busy = sum(e.self_device_time_total for e in kern) / n_ticks / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    res = {"tick_wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall if busy else None,
           "idle_share_vs_p50": 1 - busy / tick_p50_ms if busy else None,
           "kernel_launches_per_tick": sum(e.count for e in kern) / n_ticks,
           "ms_per_tick_by_class": _by_class(kern, n_ticks),
           "top": [{"name": e.key[:80], "ms_per_tick": e.self_device_time_total / n_ticks / 1e3,
                    "calls_per_tick": e.count / n_ticks} for e in top]}
    log(f"decode profile: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

MASK_ID = 3                                 # as launch/train.py and the quickstart mask


def mlm_batches(torch, cfg, n, B, S, seed):
    """``n`` batches of random tokens from ``seed``, masked by
    ``core.mlm.mask_tokens`` (BERT's 15% recipe), on the CPU."""
    from repro_torch.core.mlm import mask_tokens

    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        toks = torch.randint(4, cfg.vocab_size, (B, S), generator=gen)
        inputs, labels, mask = mask_tokens(gen, toks, cfg.vocab_size, MASK_ID)
        out.append({"tokens": inputs, "labels": labels, "loss_mask": mask})
    return out


# the key bias's exact gradient is 0 (softmax is shift-invariant): both
# devices return f32 rounding noise, held to 0 at the scale of wk's gradient
ZERO_GRAD = {"groups.0.0.mixer.bk": "groups.0.0.mixer.wk"}


def check_train_path(torch, rec, B=2, S=128, n_steps=5):
    """bert-mlm-120m at full width, 2 layers, f32: loss and every gradient
    leaf of one batch, then ``n_steps`` train steps, on cuda and on cpu
    from the same parameters and batches.  Relative error: max |cuda -
    cpu| / max |cpu| <= PATH_REL_TOL per leaf, and per loss."""
    import copy

    from repro_torch.configs import default_run_config, get_config
    from repro_torch.configs.base import LayerSpec, ShapeConfig, uniform_schedule
    from repro_torch.core.accum import accumulate_grads
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_state, loss_for, make_train_step

    cfg = dataclasses.replace(get_config("bert-mlm-120m"),
                              schedule=uniform_schedule(2, LayerSpec()))
    run = default_run_config(cfg, ShapeConfig("train_path", S, B, "train"))
    opt = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=n_steps)
    model_cpu = build_model(cfg, seed=0, device="cpu")
    batches = mlm_batches(torch, cfg, n_steps + 1, B, S, seed=1)
    res = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(model_cpu).to(dev)
        state = init_state(model, run, seed=None)
        on = lambda b: {k: v.to(dev) for k, v in b.items()}
        ops.reset_launch_counts()
        loss, grads, _ = accumulate_grads(lambda p, b: loss_for(model, p, b, run=run),
                                          state["params"], on(batches[0]), 1)
        grads = {k: g.detach().cpu() for k, g in grads.items()}
        step = make_train_step(model, run, opt)
        losses = [step(state, on(b))[1]["loss"].item() for b in batches[1:]]
        res[dev] = (loss.item(), grads, losses, dict(ops.launch_counts))
        log(f"train_path {dev}: loss {loss.item():.6f}, steps {losses}, launches {res[dev][3]}")
    counts = res["cuda"][3]
    n_fb = 1 + n_steps
    if res["cpu"][3] or counts.get("flash_attention_bwd") != 2 * n_fb \
            or counts.get("fused_xent_bwd") != n_fb:
        fail(f"train_path: cuda launches {counts}, cpu launches {res['cpu'][3]}")
    rel = lambda a, b: abs(a - b) / abs(b)
    errs = {"loss": rel(res["cuda"][0], res["cpu"][0])}
    errs["steps"] = max(rel(a, b) for a, b in zip(res["cuda"][2], res["cpu"][2]))
    gc, gp = res["cuda"][1], res["cpu"][1]
    leaf = {k: ((gc[k] - gp[k]).abs().max() / gp[k].abs().max()).item()
            for k in gp if k not in ZERO_GRAD}
    for k, ref_leaf in ZERO_GRAD.items():
        scale = gp[ref_leaf].abs().max().item()
        leaf[k] = max(gc[k].abs().max().item(), gp[k].abs().max().item()) / scale
    errs["grad_leaf"] = max(leaf.values())
    worst = max(leaf, key=leaf.get)
    log(f"train_path: relative errors {errs} (tol {PATH_REL_TOL}); worst leaf {worst}")
    if not all(v <= PATH_REL_TOL for v in errs.values()) \
            or not all(math.isfinite(x) for x in res["cuda"][2]):
        fail(f"train_path: cuda and cpu differ: {errs}, worst leaf {worst} {leaf[worst]}")
    rec["train_path"] = {"rel_err": errs, "worst_leaf": worst, "losses_cuda": res["cuda"][2],
                         "losses_cpu": res["cpu"][2], "launches": counts}


def run_train(torch, rec, seed=0, B=32, S=512, steps=20, n_prof=3):
    """bert-mlm-120m at full width and depth through trainer.train:
    f32 parameters, bf16 activations, every layer rematerialised."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.scaling import model_flops
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.runner import DEFAULT_PEAK_FLOPS, StepRunner
    from repro_torch.train.train_step import loss_chunk_len
    from repro_torch.train.trainer import train

    cfg = get_config("bert-mlm-120m")
    run = RunConfig(model=cfg, shape=ShapeConfig("train", S, B, "train"), sharding="ddp",
                    param_dtype="float32", activation_dtype="bfloat16")
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    model = build_model(cfg, seed=seed, device="cuda")
    batches = mlm_batches(torch, cfg, steps + n_prof, B, S, seed=seed + 1)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, tlog = train(model, run, opt, iter(batches[:steps]), steps=steps, log_every=1,
                        seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    c = loss_chunk_len(B, S, cfg.vocab_size, 1)
    want = train_launches_per_step(cfg, B, S)
    n_chunks = want["fused_xent_bwd"]
    per_step = {k: counts.get(k, 0) / steps for k in want}
    log(f"train: launches {counts}, per step {per_step}, expected {want}")
    if per_step != {k: float(v) for k, v in want.items()}:
        fail(f"train: kernel launches per step {per_step}, expected {want}")
    losses = [m["loss"] for m in tlog.metrics]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"train: losses {losses}")
    p50 = tlog.telemetry["step_time_p50"]
    tokens = B * S
    res = {"batch": B, "seq": S, "steps": steps, "loss_chunk": c, "loss_chunks": n_chunks,
           "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
           "step_time_p50_ms": p50 * 1e3, "tokens_per_s": tokens / p50,
           "mfu": model_flops(cfg, tokens) / (p50 * DEFAULT_PEAK_FLOPS),
           "model_flops_per_step": model_flops(cfg, tokens), "wall_s": wall,
           "launches": counts, "launches_per_step": per_step,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "telemetry": tlog.telemetry}
    res["profile"] = profile_steps(torch, StepRunner(model, run, opt), state,
                                   batches[steps:], p50)
    log("train: " + json.dumps({k: v for k, v in res.items()
                                if k not in ("losses", "telemetry", "profile")}))
    rec["train"] = res


def train_launches_per_step(cfg, B, S, micro=1):
    """Kernel launches of one train step at ``micro`` microbatches: each
    layer's attention forward, again under remat, and its backward; each
    loss chunk's nll forward, again under its checkpoint, and its
    backward; all per microbatch, whose B / micro rows set the chunks."""
    from repro_torch.train.train_step import loss_chunk_len

    n_chunks = -(-S // loss_chunk_len(B // micro, S, cfg.vocab_size, 1))
    L = cfg.n_layers
    return {"flash_attention": 2 * L * micro, "flash_attention_bwd": L * micro,
            "fused_xent": 2 * n_chunks * micro, "fused_xent_bwd": n_chunks * micro}


def check_prefetch(torch, pipe, n=16):
    """The device prefetch hands out exactly the host batches, in order,
    while the consumer's stream is kept busy (so copies run ahead and
    freed blocks are reused), at ``device_prefetch`` 2 and 4."""
    busy = torch.randn(4096, 4096, device="cuda")
    out = {}
    for size in (2, 4):
        pipe.device_prefetch = size
        bad = []
        prefetch = pipe.device_batches()
        for k, batch in zip(range(n), prefetch):
            for _ in range(4):
                busy = busy @ busy
                busy = busy / busy.norm()
            want = pipe.peek_batch(k)
            bad += [(k, key) for key, t in batch.items()
                    if not (t.is_cuda and torch.equal(t.cpu(), torch.as_tensor(want[key])))]
        prefetch.close()
        out[size] = {"batches": n, "puts": prefetch.puts, "mismatches": bad}
        if bad:
            fail(f"train_cli: device prefetch at size {size} handed out wrong batches {bad}")
    torch.cuda.synchronize()
    return out


# the corpus of train_cli's and ddp's DataPipeline: about 570 rows of 512
# tokens, 17 batches of 32 an epoch (3000 functions gave 1699 rows and
# took 43 s to build on the card machine)
CLI_FUNCTIONS = 1000


def run_train_cli(torch, rec, B=32, S=512, n_functions=CLI_FUNCTIONS, steps=10):
    """bert-mlm-120m at full width and depth through
    repro_torch.launch.train.main, over one DataPipeline data dir: (a)
    ``steps`` steps with the R3 autotune; (b) the same run with --ckpt-dir
    and --ckpt-every steps/2, stopped by the fault point after that
    checkpoint (the lr schedule spans --steps, so the run that is resumed
    must be launched with the same --steps); (d) the second half from
    that checkpoint through runner.resume and TrainLoop, the device
    prefetch 4 deep; (c) a fresh main with --resume, the second half at
    the CLI's depth 2.  (c) and (d) must each repeat (a)'s losses bit for
    bit.  The module entry point, as a user runs it, is phase ddp's
    torchrun."""
    import os
    import shutil

    import numpy as np

    from repro_torch.configs import default_run_config, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.scaling import model_flops
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.faults import TransientWorkerError
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.models.model import build_model
    from repro_torch.train.runner import DEFAULT_PEAK_FLOPS, StepRunner, TrainLoop, resume

    cfg = get_config("bert-mlm-120m")
    work = ROOT / "build" / "train_cli"
    data, ck = work / "data", work / "ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    base = ["--arch", "bert-mlm-120m", "--batch", str(B), "--seq", str(S),
            "--n-functions", str(n_functions), "--data-dir", str(data), "--log-every", "1"]
    want = train_launches_per_step(cfg, B, S)
    res = {"batch": B, "seq": S, "n_functions": n_functions, "steps": steps,
           "launches_per_step_want": want}

    def counted(tag, argv, n_steps, train=None):
        """One run, through cli.main(base + argv) unless ``train`` is
        given, its kernel launches counted from 0."""
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, tlog = train() if train else cli.main(base + argv)
        torch.cuda.synchronize()
        counts = dict(ops.launch_counts)
        n = n_steps + tlog.telemetry.get("probe_steps", 0)
        per_step = {k: counts.get(k, 0) / n for k in want}
        res[tag] = {"argv": argv, "wall_s": time.perf_counter() - t0, "launches": counts,
                    "launches_per_step": per_step, "telemetry": tlog.telemetry,
                    "losses": [m["loss"] for m in tlog.metrics], "steps": tlog.steps}
        log(f"train_cli {tag}: launches {counts} over {n} steps, per step {per_step}")
        if per_step != {k: float(v) for k, v in want.items()}:
            fail(f"train_cli {tag}: kernel launches per step {per_step}, expected {want}")
        if tlog.telemetry["device_puts"] < n_steps:
            fail(f"train_cli {tag}: {tlog.telemetry['device_puts']} batches placed by the "
                 f"device prefetch for {n_steps} steps")
        return state, tlog

    half = steps // 2
    # (a) the uninterrupted run, workers auto-tuned
    state_a, log_a = counted("a", ["--steps", str(steps), "--workers", "0"], steps)
    losses_a = res["a"]["losses"]
    if len(losses_a) != steps or not all(math.isfinite(x) for x in losses_a) \
            or not losses_a[-1] < losses_a[0]:
        fail(f"train_cli a: losses {losses_a}")
    del state_a

    # (b) the same run with checkpoints, stopped after its step-``half`` checkpoint
    ckpt_argv = ["--steps", str(steps), "--workers", "2", "--ckpt-dir", str(ck),
                 "--ckpt-every", str(half)]
    fault = {"REPRO_FAULT_PHASE": "step", "REPRO_FAULT_STEP": str(half),
             "REPRO_FAULT_MODE": "raise"}
    os.environ.update(fault)
    ops.reset_launch_counts()
    try:
        cli.main(base + ckpt_argv)
        fail(f"train_cli b: the fault point at step {half} did not stop the run")
    except TransientWorkerError as e:
        log(f"train_cli b: stopped as planned: {e}")
    finally:
        for k in fault:
            os.environ.pop(k)
    torch.cuda.synchronize()
    counts_b = dict(ops.launch_counts)
    res["b"] = {"argv": ckpt_argv, "launches": counts_b,
                "launches_per_step": {k: counts_b.get(k, 0) / (half + 1) for k in want}}
    if res["b"]["launches_per_step"] != {k: float(v) for k, v in want.items()}:
        fail(f"train_cli b: launches {counts_b} over {half + 1} steps, expected {want} a step")
    if ckpt.latest_step(str(ck)) != half:
        fail(f"train_cli b: newest committed checkpoint {ckpt.latest_step(str(ck))}, "
             f"not {half}")
    shard = Path(ckpt.step_dir(str(ck), half)) / "shard-00000.npz"
    res["b"]["ckpt_bytes"] = shard.stat().st_size
    with np.load(shard) as z:
        res["b"]["ckpt_opt_step"] = int(z["opt/step"])
    if res["b"]["ckpt_opt_step"] != half:
        fail(f"train_cli b: the step-{half} checkpoint holds opt/step "
             f"{res['b']['ckpt_opt_step']}")

    # (d) the same resume through the library's entry points, with the
    # pipeline's device prefetch 4 deep (the CLI's is 2): the second half
    # must again be (a)'s, bit for bit.  Runner and pipeline are built as the
    # CLI builds them.
    run = default_run_config(cfg, ShapeConfig("cli", S, B, "train"))
    pipe = DataPipeline.build(str(data), n_functions=n_functions, seq_len=S, batch_size=B,
                              vocab_size=cfg.vocab_size, n_workers=2, device_prefetch=4,
                              work_fn=cli.make_work_fn(cfg))
    try:
        runner = StepRunner(build_model(cfg), run,
                            AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps))
        state_d, start = resume(str(ck), runner, pipeline=pipe, step=half)
        state_d, _ = counted("d", [f"resume(step={half})", "device_prefetch=4"], steps - half,
                             lambda: TrainLoop(runner, log_every=1).run(
                                 pipe, steps, state=state_d, start_step=start))
        if res["d"]["steps"] != list(range(half + 1, steps + 1)) \
                or res["d"]["losses"] != losses_a[half:]:
            fail(f"train_cli d: resumed losses at prefetch depth 4 "
                 f"{list(zip(res['d']['steps'], res['d']['losses']))} "
                 f"!= uninterrupted {losses_a[half:]}")

        # where a step's time goes, on the CLI's f32 path and its batches
        p50 = log_a.telemetry["step_time_p50"]
        res["profile"] = profile_steps(torch, runner, state_d,
                                       [runner.place_batch(pipe.peek_batch(k)) for k in range(3)],
                                       p50)
        del state_d, runner
        res["prefetch_check"] = check_prefetch(torch, pipe)
    finally:
        pipe.close()

    # (c) resumed in a fresh main: the second half must be (a)'s, bit for bit
    state_c, log_c = counted("c", ckpt_argv + ["--resume", "--keep-last-k", "1"], steps - half)
    if res["c"]["steps"] != list(range(half + 1, steps + 1)) \
            or res["c"]["losses"] != losses_a[half:]:
        fail(f"train_cli c: resumed losses {list(zip(res['c']['steps'], res['c']['losses']))} "
             f"!= uninterrupted {losses_a[half:]}")
    res["resume_bit_exact"] = True
    del state_c
    shutil.rmtree(ck, ignore_errors=True)

    t_a, t_c = log_a.telemetry, res["c"]["telemetry"]
    tokens = B * S
    res.update(step_time_p50_ms=p50 * 1e3, tokens_per_s=tokens / p50,
               mfu=model_flops(cfg, tokens) / (p50 * DEFAULT_PEAK_FLOPS),
               data_wait_share=t_a["data_wait_s"] / t_a["total_s"],
               data_wait_ms_per_step=t_a["data_wait_s"] / steps * 1e3,
               autotune={"n_workers": t_a["n_workers"], "device_prefetch": t_a["device_prefetch"]},
               ckpt_host_copy_ms=t_c["ckpt_host_copy_s"] * 1e3,
               ckpt_write_ms=t_c["ckpt_write_s"] * 1e3, ckpt_saves=t_c["ckpt_saves"],
               ckpt_bytes=res["b"]["ckpt_bytes"],
               first_loss=losses_a[0], last_loss=losses_a[-1], launches=res["a"]["launches"])
    log("train_cli: " + json.dumps({k: v for k, v in res.items()
                                    if k not in ("a", "b", "c", "profile")}))
    rec["train_cli"] = res


# ---------------------------------------------------------------------------
# mamba2 training
# ---------------------------------------------------------------------------

def lm_batches(torch, vocab, n, B, S, seed):
    """``n`` next-token batches of random tokens from ``seed`` with the
    JAX launcher's decoder labels: the tokens rolled by one and the
    attention mask as the loss mask (the last row's final 100 positions
    padding), on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        toks = torch.randint(4, vocab, (B, S), generator=gen)
        attn = torch.ones(B, S)
        attn[-1, S - 100:] = 0.0
        toks[-1, S - 100:] = 0
        out.append({"tokens": toks, "labels": torch.roll(toks, -1, 1), "loss_mask": attn})
    return out


def ssm_launches_per_step(cfg, B, S, micro=1):
    """Kernel launches of one mamba2 train step at ``micro`` microbatches:
    each layer's scan forward, again under remat, and its backward; each
    loss chunk's nll forward, again under its checkpoint, and its
    backward; all per microbatch, whose B / micro rows set the chunks."""
    from repro_torch.train.train_step import loss_chunk_len

    n_chunks = -(-S // loss_chunk_len(B // micro, S, cfg.vocab_size, 1))
    L = cfg.n_layers
    return {"ssd_scan": 2 * L * micro, "ssd_scan_bwd": L * micro,
            "fused_xent": 2 * n_chunks * micro, "fused_xent_bwd": n_chunks * micro}


def lm_path_spec(key):
    """(cfg, launches_per_step, B, S, n_steps) of the next-token check
    ``key``, both models at full width and 2 layers, f32.
    ssm_train_path: mamba2-130m, B 2 x S 600 (a full chunk and a ragged
    one), 3 steps.  gemma_train_path: gemma3-4b (local with window 1024,
    global), B 1 x S 1100 (past the window and ragged against every
    tile), 2 steps, so that the second step's loss reads AdamW's move of
    q_norm, k_norm, post1 and post2; the kernel gate holds the windowed
    backward at B 2 and 4.  Its cpu side is nearly all the tied
    unembedding at vocab 262144: B 2 x S 1100 over four forward and
    backward passes took 167 s on the card machine's 8 cores (PERF.md
    §6)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA, LayerSpec, uniform_schedule

    if key == "ssm_train_path":
        cfg = dataclasses.replace(get_config("mamba2-130m"),
                                  schedule=uniform_schedule(2, LayerSpec(kind=MAMBA, has_mlp=False)))
        return cfg, ssm_launches_per_step, 2, 600, 3
    return gemma_cfg(2), train_launches_per_step, 1, 1100, 2


def lm_train_side(torch, key, dev):
    """One side of ``check_lm_train_path`` on ``dev``: ``n_steps`` train
    steps of the model built from seed 0 on the lm_batches of seed 1; the
    gradients AdamW gets in the first step, every step's loss and the
    kernel launches.  On cuda first the gradients of the first batch
    twice, which must be equal bit for bit."""
    from repro_torch.configs import default_run_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.accum import accumulate_grads
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig

    t0 = time.perf_counter()
    cfg, _, B, S, n_steps = lm_path_spec(key)
    run = default_run_config(cfg, ShapeConfig(key, S, B, "train"))
    opt = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=n_steps)
    model = build_model(cfg, seed=0, device="cpu").to(dev)
    state = ts.init_state(model, run, seed=None)
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in lm_batches(torch, cfg.vocab_size, n_steps, B, S, seed=1)]
    ops.reset_launch_counts()
    if dev == "cuda":
        grad = lambda: accumulate_grads(lambda p, b: ts.loss_for(model, p, b, run=run),
                                        state["params"], batches[0], 1)[1]
        first = {k: g.detach().clone() for k, g in grad().items()}
        again = grad()
        unequal = [k for k, g in again.items() if not torch.equal(g, first[k])]
        if unequal:
            fail(f"{key}: the same gradients twice differ in {unequal}")
        del first, again
    grads, real = {}, ts.adamw_update

    def spy(c, g, opt_state, params):
        if not grads:
            grads.update((k, v.detach().to("cpu", copy=True)) for k, v in g.items())
        return real(c, g, opt_state, params)

    step = ts.make_train_step(model, run, opt)
    ts.adamw_update = spy
    try:
        losses = [step(state, b)[1]["loss"].item() for b in batches]
    finally:
        ts.adamw_update = real
    out = {"loss": losses[0], "grads": grads, "losses": losses,
           "launches": dict(ops.launch_counts), "seconds": time.perf_counter() - t0}
    log(f"{key} {dev}: steps {losses}, launches {out['launches']}, {out['seconds']:.1f}s")
    return out


# The cpu sides of the next-token checks each run in a process of their
# own (``--cpu-ref KEY``), started with the script at nice 15, so that
# their minutes of 8-core work overlap the phases before them: the
# build's and the phases' threads come first, the planted faults' builds
# (nice 19) after.  gemma_train_path's took 94 s of its phase's 109 in
# process (PERF.md §6).
CPU_REF_KEYS = ("ssm_train_path", "gemma_train_path")
_children = []                      # processes the script stops if it ends early


def stop_children():
    for p in _children:
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()


def cpu_ref_file(key):
    return ROOT / "build" / "cpu_ref" / f"{key}.pt"


def start_cpu_refs(phases):
    """{key: process} of the cpu sides of the next-token checks in
    ``phases``."""
    import os

    procs = {}
    for key in CPU_REF_KEYS:
        if key in phases:
            out = cpu_ref_file(key)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.unlink(missing_ok=True)
            with open(out.with_suffix(".log"), "w") as f:
                procs[key] = subprocess.Popen(
                    ["nice", "-n", "15", sys.executable, str(ROOT / "chip_smoke.py"),
                     "--cpu-ref", key], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                    env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
            _children.append(procs[key])
    return procs


def cpu_ref_worker(torch, key):
    """The body of a ``--cpu-ref KEY`` process."""
    torch.save(lm_train_side(torch, key, "cpu"), cpu_ref_file(key))


def cpu_side(torch, key, procs):
    """The cpu side of ``key``, from its process of ``start_cpu_refs``."""
    p = procs[key]
    t0 = time.perf_counter()
    try:
        p.wait(timeout=900)
    except subprocess.TimeoutExpired:
        fail(f"{key}: the cpu side's process outlasted 900 s")
    text = cpu_ref_file(key).with_suffix(".log").read_text()
    if p.returncode != 0:
        fail(f"{key}: the cpu side's process exited {p.returncode}: {text[-3000:]}")
    log(f"{key}: waited {time.perf_counter() - t0:.1f}s for the cpu side's process: "
        f"{text.strip().splitlines()[-1] if text.strip() else ''}")
    return torch.load(cpu_ref_file(key))


def check_lm_train_path(torch, rec, key, procs):
    """A next-token model of ``lm_path_spec(key)`` on cuda and on cpu from
    the same parameters and batches (``lm_train_side``): the first step's
    loss and every gradient leaf, and every step's loss, within
    PATH_REL_TOL; on cuda the first batch's gradients twice equal bit for
    bit, and the kernel launches ``launches_per_step(cfg, B, S)`` a
    forward and backward."""
    cfg, launches_per_step, B, S, n_steps = lm_path_spec(key)
    cuda = lm_train_side(torch, key, "cuda")
    cpu = cpu_side(torch, key, procs)
    want = {k: v * (2 + n_steps) for k, v in launches_per_step(cfg, B, S).items()}
    if cpu["launches"] or cuda["launches"] != want:
        fail(f"{key}: cuda launches {cuda['launches']} (expected {want}), "
             f"cpu launches {cpu['launches']}")
    rel = lambda a, b: abs(a - b) / abs(b)
    errs = {"loss": rel(cuda["loss"], cpu["loss"]),
            "steps": max(rel(a, b) for a, b in zip(cuda["losses"], cpu["losses"]))}
    gc, gp = cuda["grads"], cpu["grads"]
    leaf = {k: ((gc[k] - gp[k]).abs().max() / gp[k].abs().max()).item() for k in gp}
    errs["grad_leaf"] = max(leaf.values())
    worst = max(leaf, key=leaf.get)
    log(f"{key}: relative errors {errs} (tol {PATH_REL_TOL}); worst leaf {worst}")
    if not all(v <= PATH_REL_TOL for v in errs.values()) or sorted(gc) != sorted(gp) \
            or not all(math.isfinite(x) for x in cuda["losses"]):
        fail(f"{key}: cuda and cpu differ: {errs}, worst leaf {worst} {leaf[worst]}")
    rec[key] = {"rel_err": errs, "worst_leaf": worst, "grad_leaf_rel": leaf,
                "losses_cuda": cuda["losses"], "losses_cpu": cpu["losses"],
                "launches": cuda["launches"], "repeat_bit_equal": True,
                "seconds_cuda": cuda["seconds"], "seconds_cpu": cpu["seconds"]}


def run_ssm_train(torch, rec, B=16, S=1024, n_functions=400, steps=10):
    """mamba2-130m at full width and depth, B x S from one DataPipeline
    data dir (400 functions: 103 rows of 1024, 6 batches an epoch, which
    the 10 steps wrap; the corpus build grows with the function count):
    (a) ``steps`` steps of launch.train.main (f32, 2 loader workers, a
    checkpoint every steps/2; phase train_cli runs the R3 autotune and
    stops a run at its fault point); (b) --resume from (a)'s first
    checkpoint, whose losses over the second half must be (a)'s bit for
    bit; (c) ``steps`` steps of trainer.train
    with bf16 parameters and activations at microbatch 2 on the
    pipeline's first batches, every gradient AdamW gets checked to be
    f32.  Launches per step, the loss falling, step p50, tokens/s, MFU;
    where the step's device time goes (torch.profiler) for (a) and (c)."""
    import shutil

    from repro_torch.configs import default_run_config, get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.scaling import model_flops
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.runner import DEFAULT_PEAK_FLOPS, StepRunner
    from repro_torch.train.trainer import train

    cfg = get_config("mamba2-130m")
    work = ROOT / "build" / "ssm_train"
    data, ck = work / "data", work / "ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    base = ["--arch", "mamba2-130m", "--batch", str(B), "--seq", str(S),
            "--n-functions", str(n_functions), "--data-dir", str(data), "--log-every", "1"]
    tokens = B * S
    res = {"batch": B, "seq": S, "steps": steps}

    def counted(tag, fn, n_steps, want):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, tlog = fn()
        torch.cuda.synchronize()
        counts = dict(ops.launch_counts)
        n = n_steps + tlog.telemetry.get("probe_steps", 0)
        per_step = {k: counts.get(k, 0) / n for k in want}
        losses = [m["loss"] for m in tlog.metrics]
        p50 = tlog.telemetry["step_time_p50"]
        res[tag] = {"wall_s": time.perf_counter() - t0, "launches": counts,
                    "launches_per_step": per_step, "launches_per_step_want": want,
                    "losses": losses, "steps": tlog.steps, "step_time_p50_ms": p50 * 1e3,
                    "tokens_per_s": tokens / p50,
                    "mfu": model_flops(cfg, tokens) / (p50 * DEFAULT_PEAK_FLOPS),
                    "telemetry": tlog.telemetry}
        log(f"ssm_train {tag}: launches {counts} over {n} steps, per step {per_step}, "
            f"p50 {p50 * 1e3:.1f} ms, losses {losses[0]:.4f} -> {losses[-1]:.4f}")
        if per_step != {k: float(v) for k, v in want.items()}:
            fail(f"ssm_train {tag}: kernel launches per step {per_step}, expected {want}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"ssm_train {tag}: losses {losses}")
        return state, tlog

    want = ssm_launches_per_step(cfg, B, S)
    half = steps // 2
    # (a) the uninterrupted CLI run, checkpointed at steps ``half`` and ``steps``
    ckpt_argv = ["--steps", str(steps), "--workers", "2", "--ckpt-dir", str(ck),
                 "--ckpt-every", str(half)]
    state_a, _ = counted("a", lambda: cli.main(base + ckpt_argv), steps, want)
    losses_a = res["a"]["losses"]
    if len(losses_a) != steps or not losses_a[-1] < losses_a[0]:
        fail(f"ssm_train a: losses {losses_a}")
    del state_a
    if not (Path(ckpt.step_dir(str(ck), half)) / "manifest.json").exists():
        fail(f"ssm_train a: no committed step-{half} checkpoint")

    # (b) the second half again, resumed from (a)'s step-``half`` checkpoint
    state_b, _ = counted("b", lambda: cli.main(base + ckpt_argv + ["--resume", "--ckpt-step",
                                                                    str(half)]),
                         steps - half, want)
    if res["b"]["steps"] != list(range(half + 1, steps + 1)) \
            or res["b"]["losses"] != losses_a[half:]:
        fail(f"ssm_train b: resumed losses {list(zip(res['b']['steps'], res['b']['losses']))} "
             f"!= uninterrupted {losses_a[half:]}")
    res["resume_bit_exact"] = True
    shutil.rmtree(ck, ignore_errors=True)

    # where the f32 CLI step's time goes, on the pipeline's batches
    pipe = DataPipeline.build(str(data), n_functions=n_functions, seq_len=S, batch_size=B,
                              vocab_size=cfg.vocab_size, work_fn=cli.make_work_fn(cfg))
    try:
        host = [pipe.peek_batch(k) for k in range(steps)]
    finally:
        pipe.close()
    runner = StepRunner(build_model(cfg), default_run_config(cfg, ShapeConfig("cli", S, B, "train")),
                        AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps))
    res["a"]["profile"] = profile_steps(torch, runner, state_b,
                                        [runner.place_batch(b) for b in host[:1]],
                                        res["a"]["step_time_p50_ms"] / 1e3)
    del state_b, runner

    # (c) bf16 parameters and activations at microbatch 2 through trainer.train
    run = RunConfig(model=cfg, shape=ShapeConfig("ssm_train_bf16", S, B, "train"), sharding="ddp",
                    param_dtype="bfloat16", activation_dtype="bfloat16", microbatch=2)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    dtypes = set()
    real = ts.adamw_update

    def spy(c, grads, opt_state, params):
        dtypes.update(str(g.dtype) for g in grads.values())
        return real(c, grads, opt_state, params)

    ts.adamw_update = spy
    try:
        model = build_model(cfg, seed=0, device="cuda")
        state_c, _ = counted("c", lambda: train(model, run, opt, iter(host), steps=steps,
                                                log_every=1, seed=0),
                             steps, ssm_launches_per_step(cfg, B, S, 2))
    finally:
        ts.adamw_update = real
    res["c"]["adamw_grad_dtypes"] = sorted(dtypes)
    if dtypes != {"torch.float32"}:
        fail(f"ssm_train c: AdamW got gradients of dtypes {sorted(dtypes)}, not only f32")
    if not res["c"]["losses"][-1] < res["c"]["losses"][0]:
        fail(f"ssm_train c: losses {res['c']['losses']}")
    runner = StepRunner(model, run, opt)
    res["c"]["profile"] = profile_steps(torch, runner, state_c,
                                        [runner.place_batch(b) for b in host[:1]],
                                        res["c"]["step_time_p50_ms"] / 1e3)
    res["c"]["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del state_c, runner, model
    torch.cuda.empty_cache()
    res.update(launches=res["a"]["launches"], first_loss=losses_a[0], last_loss=losses_a[-1],
               step_time_p50_ms=res["a"]["step_time_p50_ms"], tokens_per_s=res["a"]["tokens_per_s"],
               mfu=res["a"]["mfu"], model_flops_per_step=model_flops(cfg, tokens))
    log("ssm_train: " + json.dumps({k: v for k, v in res.items() if k not in ("a", "b", "c")}))
    rec["ssm_train"] = res


def run_gemma_train(torch, rec, B=4, S=2048, n_functions=400, steps=10):
    """gemma3-4b at full width, depth cut to 6 (its first pattern group:
    5 local layers with window 1024, then a global one; at full depth the
    f32 parameters, gradients and AdamW state alone take about 62 GB), B x
    S from the DataPipeline with the launcher's rolled next-token labels:
    (a) ``steps`` steps of trainer.train with f32 parameters and
    activations, (b) ``steps`` with bf16 ones at microbatch 2 (gradients
    summed in f32).  The loss falls in each; launches per step exact; step
    p50, tokens/s, MFU (6ND) and where the device time goes."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.scaling import model_flops
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.runner import DEFAULT_PEAK_FLOPS, StepRunner
    from repro_torch.train.trainer import train

    cfg = dataclasses.replace(gemma_cfg(6), max_position=max(S, 2048))
    data = ROOT / "build" / "gemma_train" / "data"
    t0 = time.perf_counter()
    pipe = DataPipeline.build(str(data), n_functions=n_functions, seq_len=S, batch_size=B,
                              vocab_size=cfg.vocab_size, work_fn=cli.make_work_fn(cfg))
    try:
        host = [pipe.peek_batch(k) for k in range(steps)]
    finally:
        pipe.close()
    if not all(torch.equal(b["labels"], torch.roll(b["tokens"], -1, 1)) for b in host):
        fail("gemma_train: the pipeline's labels are not the tokens rolled by one")
    tokens = B * S
    res = {"batch": B, "seq": S, "layers": cfg.n_layers, "steps": steps,
           "data_s": time.perf_counter() - t0,
           "model_flops_per_step": model_flops(cfg, tokens)}
    for tag, dtype, micro, lr in (("a", "float32", 1, 1e-3), ("b", "bfloat16", 2, 1e-3)):
        run = RunConfig(model=cfg, shape=ShapeConfig(f"gemma_train_{tag}", S, B, "train"),
                        sharding="ddp", param_dtype=dtype, activation_dtype=dtype,
                        microbatch=micro if micro > 1 else 0)
        opt = AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps)
        want = train_launches_per_step(cfg, B, S, micro)
        model = build_model(cfg, seed=0, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, tlog = train(model, run, opt, iter(host), steps=steps, log_every=1, seed=0)
        torch.cuda.synchronize()
        counts = dict(ops.launch_counts)
        per_step = {k: counts.get(k, 0) / steps for k in want}
        losses = [m["loss"] for m in tlog.metrics]
        p50 = tlog.telemetry["step_time_p50"]
        r = {"dtype": dtype, "microbatch": micro, "wall_s": time.perf_counter() - t0,
             "launches": counts, "launches_per_step": per_step, "launches_per_step_want": want,
             "losses": losses, "step_time_p50_ms": p50 * 1e3, "tokens_per_s": tokens / p50,
             "mfu": model_flops(cfg, tokens) / (p50 * DEFAULT_PEAK_FLOPS),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "telemetry": tlog.telemetry}
        log(f"gemma_train {tag}: launches {counts} over {steps} steps, per step {per_step}, "
            f"p50 {p50 * 1e3:.1f} ms, losses {losses[0]:.4f} -> {losses[-1]:.4f}")
        if per_step != {k: float(v) for k, v in want.items()}:
            fail(f"gemma_train {tag}: kernel launches per step {per_step}, expected {want}")
        if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            fail(f"gemma_train {tag}: losses {losses}")
        runner = StepRunner(model, run, opt)
        r["profile"] = profile_steps(torch, runner, state,
                                     [runner.place_batch(b) for b in host[:2]], p50)
        res[tag] = r
        del state, runner, model, tlog
        torch.cuda.empty_cache()
    a = res["a"]
    res.update(launches=a["launches"], first_loss=a["losses"][0], last_loss=a["losses"][-1],
               step_time_p50_ms=a["step_time_p50_ms"], tokens_per_s=a["tokens_per_s"],
               mfu=a["mfu"])
    log("gemma_train: " + json.dumps({k: v for k, v in res.items() if k not in ("a", "b")}))
    rec["gemma_train"] = res


# ---------------------------------------------------------------------------
# data parallel: two ranks on the one card over gloo
# ---------------------------------------------------------------------------

DDP_WORLD = 2
# per leaf, max |2 ranks - reference| / max |reference|.  The reference of
# DDP_GRAD_REL is one process computing the same global loss on the ranks'
# row shards (each shard's nll over the global mask sum, the backwards
# accumulated, no collective): it isolates what the sync adds.  The
# one-process 8-row batch is held at PATH_REL_TOL: computing it on 4-row
# shards moves embed.positions by 1.04e-5 of its scale on the card (cuBLAS
# picks its kernels by shape; 9e-7 on the CPU), with or without a
# collective (recorded as ``shards_vs_batch``; PERF.md, data parallel).
DDP_GRAD_REL = 1e-5
DDP_LOSS_REL = 1e-5                  # ddp_path: each step's loss, against the 8-row batch
DDP_TRAJ_REL = 1e-4                  # ddp: rank 0's losses against one process, 10 steps
# the ddp phase's learning rate.  Data parallelism reorders f32 sums (3
# loss chunks of 244 positions against 5 of 122, 16-row against 32-row
# products), and AdamW's early steps are nearly lr * sign(g): a gradient
# element near zero whose sign the rounding flips moves by 2 lr.  Over
# 20 steps rank 0 drifted from one process by about lr of the loss: 2.0e-3
# at the launcher's 3e-3, 1.2e-3 at 1e-3, 9.8e-5 at 1e-4 on the H100
# (PERF.md, data parallel).  At 3e-3 the phase holds the ranks instead to
# one process in their f32 order with no collective (``order_witness``),
# bit for bit
DDP_LR = 1e-5
DDP_PATH_MB = (0.05, 25.0)           # bucket sizes of ddp_path: several buckets, and the default
DDP_RAGGED = (512, 300, 17, 450, 511, 128, 64, 256)   # loss-mask length of each row


def leaf_errors(ours, ref):
    """Per leaf max |ours - ref| / max |ref|; the ZERO_GRAD leaves (exact
    gradient 0) are held to 0 at the scale of their reference leaf."""
    err = {k: ((ours[k] - ref[k]).abs().max() / ref[k].abs().max()).item()
           for k in ref if k not in ZERO_GRAD}
    for k, ref_leaf in ZERO_GRAD.items():
        err[k] = max(ours[k].abs().max().item(), ref[k].abs().max().item()) \
            / ref[ref_leaf].abs().max().item()
    return err


def ddp_batches(torch, cfg, n, B=8, S=512, seed=7):
    """``n`` masked global batches whose rows have the loss-mask lengths
    DDP_RAGGED (the two ranks' shards hold different token counts)."""
    out = mlm_batches(torch, cfg, n, B, S, seed)
    for b in out:
        for r, length in enumerate(DDP_RAGGED[:B]):
            b["loss_mask"][r, length:] = 0
    return out


def spawn_ddp(mode, spec, timeout=900):
    """``python3 chip_smoke.py --ddp-worker MODE`` in DDP_WORLD processes
    joined through a file store (the JAX package's coordinator
    variables), on the one card; returns each rank's result.  All are
    stopped, and the phase fails, if one fails or outlasts ``timeout``."""
    import os

    work = ROOT / "build" / "ddp"
    work.mkdir(parents=True, exist_ok=True)
    store = work / f"store-{mode}-{time.time_ns()}"
    outs = [work / f"{mode}-rank{r}.json" for r in range(DDP_WORLD)]
    for o in outs:
        o.unlink(missing_ok=True)
    procs = []
    for r in range(DDP_WORLD):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "REPRO_COORDINATOR": f"file://{store}", "REPRO_NUM_PROCESSES": str(DDP_WORLD),
               "REPRO_PROCESS_ID": str(r), "REPRO_DIST_TIMEOUT_S": "300"}
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker", mode,
             "--ddp-spec", json.dumps({**spec, "out": str(outs[r])})],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, t_end = [], time.time() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, t_end - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        fail(f"ddp {mode}: a rank outlasted {timeout} s")
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"ddp {mode}: rank {r} exited {p.returncode}: {text[-3000:]}")
    return [json.loads(o.read_text()) for o in outs]


def ddp_worker(torch, mode, spec):
    """One rank of a ``spawn_ddp`` run: join the group, run ``mode``, and
    write the result where ``spec["out"]`` says."""
    import torch.distributed as dist

    from repro_torch.distributed import maybe_initialize_distributed

    info = maybe_initialize_distributed()
    res = {"rank": info.rank, "world": info.world, "backend": info.backend,
           "device": str(info.device)}
    res.update((ddp_path_rank if mode == "path" else ddp_profile_rank)(torch, info, spec))
    Path(spec["out"]).write_text(json.dumps(res))
    dist.destroy_process_group()


def _ddp_path_setup(torch):
    from repro_torch.configs import default_run_config, get_config
    from repro_torch.configs.base import LayerSpec, ShapeConfig, uniform_schedule
    from repro_torch.train.optimizer import AdamWConfig

    cfg = dataclasses.replace(get_config("bert-mlm-120m"),
                              schedule=uniform_schedule(2, LayerSpec()))
    run = default_run_config(cfg, ShapeConfig("ddp_path", 512, 8, "train"))
    return cfg, run, AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=5), ddp_batches(torch, cfg, 6)


def ddp_path_rank(torch, info, spec):
    """ddp_path on one rank: the summed gradients of batch 0 at each bucket
    size of DDP_PATH_MB against the one-process ones (``spec["ref"]``),
    then 5 steps at 25 MB; all-reduces and hook firings counted."""
    import numpy as np

    from repro_torch.distributed import gradsync
    from repro_torch.distributed.sharding import ParallelPlan
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import init_state, make_grad_fn, make_train_step

    cfg, run, opt, batches = _ddp_path_setup(torch)
    model = build_model(cfg, seed=0, device=info.device)
    rows = slice(info.rank * 4, (info.rank + 1) * 4)
    local = [{k: v[rows].to(info.device) for k, v in b.items()} for b in batches]
    refs = {}
    for name in ("shards", "batch"):
        with np.load(spec[name]) as z:
            refs[name] = {k: torch.from_numpy(z[k]).to(info.device) for k in z.files}
    out = {"grads": {}}
    for mb in DDP_PATH_MB:
        plan = ParallelPlan.for_run(run, info.world, grad_bucket_mb=mb)
        gf = make_grad_fn(model, run, plan)
        params = init_state(model, run, seed=None)["params"]
        gradsync.reset_counts()
        ops.reset_launch_counts()
        loss, grads, _ = gf(params, local[0])
        g = {"grad_sync": plan.grad_sync, "n_buckets": len(gf.sync.buckets),
             "all_reduces": gradsync.counts["grad_all_reduce"],
             "hook_fires": sorted(set(gf.sync.hook_fires)), "loss": loss.item(),
             "launches": dict(ops.launch_counts)}
        for name, ref in refs.items():
            err = leaf_errors(grads, ref)
            worst = max(err, key=err.get)
            g[name] = {"max_rel_err": err[worst], "worst_leaf": worst}
        out["grads"][str(mb)] = g
        del params, grads
    plan = ParallelPlan.for_run(run, info.world, grad_bucket_mb=25.0)
    state = init_state(model, run, seed=None)
    step = make_train_step(model, run, opt, plan)
    out["losses"], out["step_all_reduces"], out["step_hook_fires"] = [], [], []
    for b in local[1:]:
        gradsync.reset_counts()
        state, m = step(state, b)
        out["losses"].append(m["loss"].item())
        out["step_all_reduces"].append(gradsync.counts["grad_all_reduce"])
        out["step_hook_fires"].append(sorted(set(step.sync.hook_fires)))
    out["step_n_buckets"] = len(step.sync.buckets)
    return out


def check_ddp_path(torch, rec):
    """bert-mlm-120m at full width, 2 layers, f32, global batch 8 x 512
    with ragged masks: two ranks on the card over gloo against one
    process on the card (the summed gradients against the same global
    loss on the ranks' row shards and against the 8-row batch; 5 steps
    of losses), one all-reduce per bucket per step, every hook once."""
    import numpy as np

    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import (init_state, make_grad_fn, make_train_step,
                                              shard_sums)

    cfg, run, opt, batches = _ddp_path_setup(torch)
    model = build_model(cfg, seed=0, device="cuda")
    on = [{k: v.cuda() for k, v in b.items()} for b in batches]
    refs = {"batch": ROOT / "build" / "ddp" / "path_ref_batch.npz",
            "shards": ROOT / "build" / "ddp" / "path_ref_shards.npz"}
    refs["batch"].parent.mkdir(parents=True, exist_ok=True)
    params = init_state(model, run, seed=None)["params"]
    loss, grads, _ = make_grad_fn(model, run)(params, on[0])
    np.savez(refs["batch"], **{k: g.detach().cpu().numpy() for k, g in grads.items()})
    # the same global loss on the ranks' row shards, in this process
    params = init_state(model, run, seed=None)["params"]
    den = on[0]["loss_mask"].sum().clamp(min=1.0)
    rows = on[0]["tokens"].shape[0] // DDP_WORLD
    for r in range(DDP_WORLD):
        s_nll, _, _, aux = shard_sums(model, params, {k: v[r * rows:(r + 1) * rows]
                                                      for k, v in on[0].items()}, run)
        (s_nll / den + aux / DDP_WORLD).backward()
    shard_grads = {k: p.grad for k, p in params.named_parameters()}
    np.savez(refs["shards"], **{k: g.cpu().numpy() for k, g in shard_grads.items()})
    # the rounding of the shard shapes alone, no collective (recorded)
    err = leaf_errors(shard_grads, grads)
    worst = max(err, key=err.get)
    state = init_state(model, run, seed=None)
    step = make_train_step(model, run, opt)
    want = [step(state, b)[1]["loss"].item() for b in on[1:]]
    one = {"loss": loss.item(), "losses": want,
           "shards_vs_batch": {"max_rel_err": err[worst], "worst_leaf": worst}}
    del model, params, grads, shard_grads, state, on
    torch.cuda.empty_cache()
    ranks = spawn_ddp("path", {k: str(v) for k, v in refs.items()})
    for v in refs.values():
        v.unlink()
    bad = []
    for r in ranks:
        if r["backend"] != "gloo" or r["world"] != DDP_WORLD:
            bad.append(f"rank {r['rank']}: backend {r['backend']}, world {r['world']}")
        for mb, g in r["grads"].items():
            if g["grad_sync"] != "bucketed_overlap" or g["all_reduces"] != g["n_buckets"] \
                    or g["hook_fires"] != [1] \
                    or not g["shards"]["max_rel_err"] <= DDP_GRAD_REL \
                    or not g["batch"]["max_rel_err"] <= PATH_REL_TOL \
                    or not abs(g["loss"] - one["loss"]) <= DDP_LOSS_REL * abs(one["loss"]):
                bad.append(f"rank {r['rank']} at {mb} MB: {g}")
        nb = r["step_n_buckets"]
        rel = max_rel(r["losses"], want)
        r["losses_max_rel_err"] = rel
        if r["step_all_reduces"] != [nb] * len(want) or \
                any(h != [1] for h in r["step_hook_fires"]) or not rel <= DDP_LOSS_REL:
            bad.append(f"rank {r['rank']} steps: losses {r['losses']} (one process {want}), "
                       f"all-reduces {r['step_all_reduces']} for {nb} buckets, "
                       f"hooks {r['step_hook_fires']}")
    log(f"ddp_path: one process {one}; ranks {json.dumps(ranks)}")
    if len(DDP_PATH_MB) > 1 and ranks[0]["grads"][str(DDP_PATH_MB[0])]["n_buckets"] <= \
            ranks[0]["grads"][str(DDP_PATH_MB[-1])]["n_buckets"]:
        bad.append("the small bucket size did not make more buckets")
    if bad:
        fail("ddp_path: " + "; ".join(bad))
    rec["ddp_path"] = {"one_process": one, "ranks": ranks}


def ddp_profile_rank(torch, info, spec):
    """The ddp cell's step on one rank, full depth, f32, ``spec["batch"]``
    rows a rank: ``spec["steps"]`` steps at ``spec["lr"]`` on this rank's
    rows of the WITNESS_SEED batches (the losses), timed with the device
    synchronised at the end of the backward and after each wait
    (``BucketedAllReduce.timed``): step wall time, each bucket's
    all-reduce wait and the exposed sync, the first two steps left out;
    then the step under torch.profiler for its device busy time."""
    import numpy as np

    from repro_torch.models.model import build_model
    from repro_torch.train.runner import StepRunner

    B, S, n = spec["batch"], spec["seq"], spec["steps"]
    cfg, run, opt = witness_setup(B * info.world, S, n, spec["lr"])
    runner = StepRunner(build_model(cfg, seed=0, device=info.device), run, opt)
    runner.sync.timed = True
    rows = slice(info.rank * B, (info.rank + 1) * B)
    batches = [runner.place_batch({k: v[rows] for k, v in b.items()})
               for b in mlm_batches(torch, cfg, n, B * info.world, S, WITNESS_SEED)]
    state = runner.init_state(0)
    losses, wall, waits, exposed = [], [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = runner(state, b)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        waits.append(runner.sync.last_wait_s)
        exposed.append(runner.sync.last_exposed_s)
        losses.append(m["loss"].item())
    wall, waits, exposed = wall[2:], waits[2:], exposed[2:]
    p50 = float(np.median(wall))
    res = {"losses": losses, "step_p50_ms": p50 * 1e3,
           "exposed_sync_ms": float(np.median(exposed)) * 1e3,
           "bucket_wait_ms": [float(np.median(w)) * 1e3 for w in zip(*waits)],
           "bucket_mb": [b.mb for b in runner.sync.buckets]}
    runner.sync.timed = False
    res["profile"] = profile_steps(torch, runner, state, batches[:3], p50)
    return res


# the ddp phase's witness of f32 reordering: 10 steps at the launcher's
# default lr on batches from WITNESS_SEED, by 2 ranks and by one process
# in the ranks' order (gated bit for bit) and in the batch's (recorded)
WITNESS_LR = 3e-3
WITNESS_SEED = 11


def witness_setup(global_batch, S, steps, lr):
    from repro_torch.configs import default_run_config, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config("bert-mlm-120m")
    run = default_run_config(cfg, ShapeConfig("ddp", S, global_batch, "train"))
    return cfg, run, AdamWConfig(lr=lr, warmup_steps=2, total_steps=steps)


def order_witness(torch, B, S, steps, lr):
    """One process, no collective, on the ranks' global batches at ``lr``:
    the losses of the plain step over all DDP_WORLD x B rows, and of the
    same step with its gradient formed as the ranks form it (each B-row
    shard's nll over the global mask sum, 3 loss chunks of 244 positions
    against 5 of 122, the shards' backwards accumulated)."""
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.runner import StepRunner
    from repro_torch.train.train_step import shard_sums

    cfg, run, opt = witness_setup(B * DDP_WORLD, S, steps, lr)
    runner = StepRunner(build_model(cfg, seed=0, device="cuda"), run, opt)
    batches = [runner.place_batch(b)
               for b in mlm_batches(torch, cfg, steps, B * DDP_WORLD, S, WITNESS_SEED)]
    state = runner.init_state(0)
    plain = [runner(state, b)[1]["loss"].item() for b in batches]
    state, shards = runner.init_state(0), []
    named = dict(state["params"].named_parameters())
    for b in batches:
        den = b["loss_mask"].sum().clamp(min=1.0)
        nll = aux_sum = 0.0
        for r in range(DDP_WORLD):
            s_nll, _, _, aux = shard_sums(runner.model, state["params"],
                                          {k: v[r * B:(r + 1) * B] for k, v in b.items()}, run)
            (s_nll / den + aux / DDP_WORLD).backward()
            nll, aux_sum = nll + s_nll.detach(), aux_sum + aux.detach()
        _, state["opt"], _ = adamw_update(opt, {k: p.grad for k, p in named.items()},
                                          state["opt"], named)
        for p in named.values():
            p.grad = None
        shards.append((nll / den + aux_sum / DDP_WORLD).item())
    return plain, shards


def max_rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def torchrun_train(args, tag, timeout=900):
    """``python -m torch.distributed.run --standalone --nproc-per-node
    DDP_WORLD -m repro_torch.launch.train ARGS``: returns (exit code, each
    rank's stdout and stderr, torchrun's own output), the ranks' from
    torchrun's log directory."""
    import os
    import shutil

    logs = ROOT / "build" / "ddp" / f"logs-{tag}"
    shutil.rmtree(logs, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(DDP_WORLD), "--log-dir", str(logs), "--redirects", "3",
           "-m", "repro_torch.launch.train", *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    _children.append(proc)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_children()
        raise
    out = subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)
    ranks = []
    for r in range(DDP_WORLD):
        found = sorted(logs.glob(f"**/attempt_0/{r}/stdout.log"))
        err = sorted(logs.glob(f"**/attempt_0/{r}/stderr.log"))
        ranks.append({"stdout": found[-1].read_text() if found else "",
                      "stderr": err[-1].read_text() if err else ""})
    log(f"ddp {tag}: torchrun exited {out.returncode} in {time.perf_counter() - t0:.1f}s")
    return out.returncode, ranks, out


def _cli_lines(stdout):
    """The launcher's per-step losses {step: loss} and its [gradsync],
    [kernels] and [telemetry] fields."""
    import re

    losses = {int(m.group(1)): float(m.group(2))
              for m in re.finditer(r"^\s+step\s+(\d+) loss=(\S+)", stdout, re.M)}
    fields = {}
    for line in stdout.splitlines():
        if line.startswith("[kernels]"):
            fields["launches"] = json.loads(line.split("launches=", 1)[1])
        elif line.startswith("[gradsync]") or line.startswith("[telemetry]") \
                or line.startswith("[plan] mode=") or line.startswith("[dist]"):
            key = line[1:line.index("]")]
            fields[key] = line
    return losses, fields


def _field(line, name):
    import re

    m = re.search(rf"{name}=(\S+)", line or "")
    return m.group(1) if m else None


def _shards_equal(a, b, keys=None):
    """Whether two checkpoint shards hold the same arrays, bit for bit."""
    import numpy as np

    with np.load(a) as x, np.load(b) as y:
        names = [k for k in x.files if keys is None or k.split("/")[0] in keys]
        return sorted(x.files) == sorted(y.files) and \
            all(np.array_equal(x[k], y[k]) for k in names)


def run_ddp(torch, rec, B=16, S=512, n_functions=CLI_FUNCTIONS, steps=10):
    """bert-mlm-120m at full width and depth through ``torch.distributed.run
    -m repro_torch.launch.train`` with 2 ranks on the card (gloo), f32,
    --batch 16 a rank from the DataPipeline: (a) ``steps`` steps with
    checkpoints at steps/2 and at the end; (c) resumed by 2 ranks from
    (a)'s first one to ``steps``; both at lr DDP_LR.  Against one process
    at --batch 32 in this process: rank 0's losses within DDP_TRAJ_REL; the ranks'
    checkpoints of (a) equal each other (replicas) and (c)'s, bit for bit;
    launches and all-reduces per rank per step.  Then ``steps`` steps at
    WITNESS_LR by one process in two f32 orders (``order_witness``) and by
    2 ranks spawned here, which also time the step and profile it: the
    ranks' losses equal each other and the one process's in their order
    bit for bit; the gaps to the batch's order recorded."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core.scaling import model_flops
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.train import checkpoint as ckpt

    cfg = get_config("bert-mlm-120m")
    work = ROOT / "build" / "ddp"
    ck_a, ck_b = work / "ckpt-a", work / "ckpt-b"
    for d in (ck_a, ck_b):
        shutil.rmtree(d, ignore_errors=True)
    base = ["--arch", "bert-mlm-120m", "--seq", str(S), "--n-functions", str(n_functions),
            "--data-dir", str(ROOT / "build" / "train_cli" / "data"), "--log-every", "1",
            "--workers", "2", "--steps", str(steps), "--lr", str(DDP_LR)]
    want = train_launches_per_step(cfg, B, S)
    res = {"batch_per_rank": B, "world": DDP_WORLD, "seq": S, "steps": steps,
           "launches_per_step_want": want}

    half = steps // 2
    rc, ranks_a, out = torchrun_train(base + ["--batch", str(B), "--ckpt-dir", str(ck_a),
                                             "--ckpt-every", str(half)], "a")
    if rc != 0:
        fail(f"ddp a: torchrun exited {rc}: {out.stderr[-2000:]} "
             f"{[r['stderr'][-2000:] for r in ranks_a]}")
    parsed = [_cli_lines(r["stdout"]) for r in ranks_a]
    bad = []
    for r, (losses, f) in enumerate(parsed):
        if f"process {r}/{DDP_WORLD} backend=gloo" not in f.get("dist", ""):
            bad.append(f"rank {r} [dist]: {f.get('dist')}")
        per_step = {k: f.get("launches", {}).get(k, 0) / steps for k in want}
        n_red = _field(f.get("gradsync"), "per_step")
        res[f"rank{r}"] = {"losses": [losses.get(i) for i in range(1, steps + 1)],
                           "launches_per_step": per_step, "lines": f}
        if per_step != {k: float(v) for k, v in want.items()}:
            bad.append(f"rank {r}: launches per step {per_step}, expected {want}")
        nb = int(_field(f.get("plan"), "buckets") or -1)
        if n_red is None or float(n_red) != nb or nb != 11 or \
                _field(f.get("gradsync"), "hooks_once") != "True":
            bad.append(f"rank {r}: {f.get('gradsync')} for {nb} buckets (11 expected)")
    if parsed[0][0] != parsed[1][0]:
        bad.append("the ranks printed different losses")
    shard = lambda d, r: Path(ckpt.step_dir(str(d), steps)) / f"shard-{r:05d}.npz"
    if not _shards_equal(shard(ck_a, 0), shard(ck_a, 1), keys=("params", "opt")):
        bad.append("the ranks' final parameters or moments differ")
    if bad:
        fail("ddp a: " + "; ".join(bad))

    # (c) resumed by 2 ranks from a copy of (a)'s step-``half`` checkpoint
    # (its own directory, so that (a)'s final one stays to compare with).
    # It is not timed, so it runs in a thread while this process runs the
    # one-process references on the card: the run at the global batch,
    # then order_witness.  A run stopped by a step fault and resumed under
    # torchrun is the CPU test
    # test_two_processes_stopped_and_resumed_repeat_their_losses.
    shutil.copytree(ckpt.step_dir(str(ck_a), half), ckpt.step_dir(str(ck_b), half))
    ck_args = base + ["--batch", str(B), "--ckpt-dir", str(ck_b), "--ckpt-every", str(half)]
    resumed = {}

    def resume():
        try:
            resumed["c"] = torchrun_train(ck_args + ["--resume"], "c")
        except Exception as e:      # noqa: BLE001 - reported below
            resumed["error"] = repr(e)

    thread = threading.Thread(target=resume, daemon=True)
    thread.start()
    ops.reset_launch_counts()
    _, log_one = cli.main(base + ["--batch", str(B * DDP_WORLD)])
    one = [m["loss"] for m in log_one.metrics]
    res["one_process"] = {"losses": one, "beside": "run c",
                          "step_time_p50_ms": log_one.telemetry["step_time_p50"] * 1e3}
    plain, shards = order_witness(torch, B, S, steps, WITNESS_LR)
    torch.cuda.empty_cache()
    thread.join()

    l0 = res["rank0"]["losses"]
    rel = max_rel(l0, one) if None not in l0 else math.inf
    res["traj_max_rel_err"] = rel
    if not rel <= DDP_TRAJ_REL:
        fail(f"ddp a: rank 0 losses {l0} vs one process {one}: max rel {rel}")
    if "error" in resumed:
        fail(f"ddp c: {resumed['error']}")
    rc_c, ranks_c, out = resumed["c"]
    if rc_c != 0:
        fail(f"ddp c: torchrun exited {rc_c}: {[r['stderr'][-2000:] for r in ranks_c]}")
    for r, rank in enumerate(ranks_c):
        losses, _ = _cli_lines(rank["stdout"])
        want_c = {i: parsed[r][0][i] for i in range(half + 1, steps + 1)}
        if f"[resume] host {r} restored shard at step {half}" not in rank["stdout"] \
                or losses != want_c or not _shards_equal(shard(ck_a, r), shard(ck_b, r)):
            fail(f"ddp c: rank {r} resumed losses {losses} != uninterrupted {want_c}, or "
                 "its final checkpoint differs")
    res["resume_bit_exact"] = True
    for d in (ck_a, ck_b):
        shutil.rmtree(d, ignore_errors=True)

    f0 = parsed[0][1]
    p50 = float(_field(f0.get("telemetry"), "step_p50").rstrip("ms")) / 1e3
    tokens = B * S * DDP_WORLD
    res.update(step_time_p50_ms=p50 * 1e3, global_tokens_per_s=tokens / p50,
               mfu_per_card=model_flops(cfg, tokens) / DDP_WORLD / (p50 * PEAK_BF16_FLOPS),
               plan=f0.get("plan"), gradsync_line=f0.get("gradsync"),
               launches=parsed[0][1].get("launches", {}))
    res["profile"] = spawn_ddp("profile", {"batch": B, "seq": S, "steps": steps,
                                           "lr": WITNESS_LR})
    ranks = [p.pop("losses") for p in res["profile"]]
    if ranks[0] != ranks[1] or ranks[0] != shards:
        fail(f"ddp witness at lr {WITNESS_LR}: the ranks' losses {ranks} differ from each "
             f"other or from one process in their order {shards}")
    res["lr_witness"] = {
        "lr": WITNESS_LR, "plain": plain, "shard_order": shards, "ranks": ranks[0],
        **{f"{name}{tag}": max_rel(a[:k], b[:k])
           for name, a, b in (("shard_order_vs_plain", shards, plain),
                              ("ranks_vs_plain", ranks[0], plain),
                              ("ranks_vs_shard_order", ranks[0], shards))
           for tag, k in (("", steps), ("_first6", 6))}}
    log("ddp lr witness: " + json.dumps(res["lr_witness"]))
    log("ddp: " + json.dumps({k: v for k, v in res.items()
                              if k not in ("rank0", "rank1", "profile")}))
    log("ddp profile: " + json.dumps([{k: v for k, v in p.items() if k != "profile"}
                                      for p in res["profile"]]))
    rec["ddp"] = res


REPO_KERNELS = ("flash_fwd", "dq_wgmma", "dkdv_wgmma", "dq_mma", "dkdv_mma", "dq_f32",
                "dkdv_f32", "delta_kernel", "split3", "xent_fwd", "xent_bwd", "paged_partial",
                "paged_wgmma", "paged_combine", "ssd_scan_kernel", "ssd_state_wgmma",
                "ssd_carry", "ssd_out_wgmma", "ssd_state_f32_wgmma", "ssd_out_f32_wgmma",
                "ssd_bwd_")


def _kernel_class(name):
    if any(k in name for k in REPO_KERNELS):
        return "repo kernels"
    if any(k in name for k in ("nvjet", "gemm", "cutlass", "xmma", "cublas")):
        return "cuBLAS products"
    if "at::native" in name:
        return "PyTorch elementwise / reduce / copy"
    return "other"


def profile_steps(torch, runner, state, batches, step_p50_s):
    """Where a train step's time goes: a few steps under torch.profiler;
    device busy time and launches per step, and the top device
    operations (the profiler slows the host, so the idle share is also
    given against the unprofiled step p50)."""
    from torch.profiler import ProfilerActivity, profile

    n = len(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, _ = runner(state, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    kern = _device_kernels(torch, prof)
    busy = sum(e.self_device_time_total for e in kern) / n / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    by_class = _by_class(kern, n)
    res = {"step_wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall if busy else None,
           "idle_share_vs_p50": 1 - busy / (step_p50_s * 1e3) if busy else None,
           "kernel_launches_per_step": sum(e.count for e in kern) / n,
           "ms_per_step_by_class": by_class,
           "repo_kernels": {e.key[:60]: e.self_device_time_total / n / 1e3 for e in kern
                            if _kernel_class(e.key) == "repo kernels"},
           "top": [{"name": e.key[:80], "ms_per_step": e.self_device_time_total / n / 1e3,
                    "calls_per_step": e.count / n} for e in top]}
    log(f"train profile: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=20, reps=5):
    """(device ms, call ms) per call.  Device: ``iters`` calls captured in
    one CUDA graph and replayed, so the host's launch overhead drops out.
    Call: CUDA events around back-to-back eager calls, which includes
    that overhead when it is longer than the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    dev = a.elapsed_time(b) / (reps * iters)
    return dev, eager_ms(torch, fn, iters, warm=0)


def eager_ms(torch, fn, iters=20, warm=3):
    """ms per call of back-to-back eager calls, by CUDA events.  For the
    autograd backwards (plain, library), which run on the autograd
    engine's streams and are not captured in a graph here."""
    for _ in range(warm):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _bound(flops, nbytes, peak_flops):
    """(bound ms, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def _flash_peak(q):
    """The card's peak for a flash body's products: bf16 on the tensor
    cores; f32 as six bf16 passes (PEAK_F32_SPLIT_FLOPS)."""
    return PEAK_F32_SPLIT_FLOPS if q.element_size() == 4 else PEAK_BF16_FLOPS


def attn_pairs(S, causal, window=None):
    """The (query, key) pairs a row-wise mask leaves: keys j <= i when
    causal, and j > i - window with a window (the pairs ``hidden_mask``
    does not hide)."""
    import numpy as np

    if window is None:
        return S * (S + 1) / 2 if causal else S * S
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1)
    hi = i if causal else np.full(S, S - 1)
    return float((hi - lo + 1).sum())


def flash_bwd_bound(q, k, causal, peak=None, window=None):
    """(bound ms, what bounds it) of a flash backward: five products (S,
    dP, dV, dK, dQ) of 2 D flops per unmasked (query, key) pair and head
    at ``peak`` (default ``_flash_peak``); q, o, do, dq and k, v, dk, dv
    moved once in the inputs' dtype, the f32 lse read once."""
    B, S, H, D = q.shape
    pairs = attn_pairs(S, causal, window)
    nbytes = q.element_size() * B * S * D * (4 * H + 4 * k.shape[2]) + 4 * B * H * S
    return _bound(10 * B * H * D * pairs, nbytes, peak or _flash_peak(q))


def device_ms_by_kernel(torch, fn, n=10):
    """{device kernel: ms per call} of ``n`` eager calls of ``fn`` under
    torch.profiler: how a call's device time splits between its kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / n / 1e3 for e in _device_kernels(torch, prof)}


def sdpa_bwd(torch, q, k, v, do, causal):
    """SDPA's flash-attention backward op (in f32, which the flash op
    refuses, the memory-efficient one's) on (B, H, S, D) copies of the
    inputs, its forward run once: a callable that runs only the backward,
    so that a CUDA graph can hold it.  K and V are repeated to H heads (the
    op takes no GQA), so for GQA it computes dk and dv per query head."""
    rep_ = q.shape[2] // k.shape[2]
    qt, dot = (x.transpose(1, 2).contiguous() for x in (q, do))
    kt, vt = (x.repeat_interleave(rep_, dim=2).transpose(1, 2).contiguous() for x in (k, v))
    if q.dtype == torch.float32:
        o, lse, seed, offset = torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, None, True, 0.0, causal)
        return lambda: torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            dot, qt, kt, vt, None, o, lse, seed, offset, 0.0, [True, True, True, False], causal)
    o, lse, cq, ck, mq, mk, seed, offset, _ = \
        torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, causal)
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, o, lse, cq, ck, mq, mk, 0.0, causal, seed, offset)


def window_mask(torch, S, window, device):
    """SDPA's boolean mask (True: attend) of a causal sliding window."""
    return ~hidden_mask(torch, S, True, window, device)


def time_flash_bwd(torch, checked, what, q, k, v, do, causal, window=None, iters=20, reps=5):
    """The backward kernel at one shape against the gate, its bound, the
    plain version's autograd (eager) and SDPA's backward op: ``ms`` and
    ``library_ms`` by CUDA-graph replay, ``library_eager_ms`` SDPA's
    autograd backward by back-to-back eager calls, and the kernel's
    device time split by its device kernels.  With a (causal) window SDPA
    takes it as an explicit mask, and its backward op takes no mask:
    ``library_ms`` is then its autograd backward, eager."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    ratio = checked(f"flash_bwd {what}", flash_bwd_reading(torch, q, k, v, do, causal, window))
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    run = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    ms, call_ms = time_ms(torch, run, iters, reps)
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    mask = None if window is None else window_mask(torch, q.shape[1], window, q.device)
    with torch.enable_grad():
        o_plain = ref.flash_attention_ref(qr, kr, vr, causal=causal, window=window)
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               is_causal=causal and mask is None,
                                               enable_gqa=q.shape[2] != k.shape[2])
    plain_ms = eager_ms(torch, lambda: torch.autograd.grad(
        o_plain, (qr, kr, vr), do, retain_graph=True))
    f32 = q.dtype == torch.float32
    plain_err = None
    if f32:     # the plain f32 version against the gate's f64 reference
        got = torch.autograd.grad(o_plain, (qr, kr, vr), do, retain_graph=True)
        want = _attention_grads64(torch, q, k, v, do, causal, window)
        plain_err = max((g.double() - w).abs().max().item() for g, w in zip(got, want))
        del got, want
        log(f"time flash_bwd {what}: the plain f32 version against f64: max_abs_err "
            f"{plain_err:.3e}, error/limit {plain_err / F32_TOL:.3f}")
    lib_eager = eager_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    del o_plain, o_lib
    if window is not None:
        lib_ms, lib_call_ms = lib_eager, None
    else:
        try:
            lib_ms, lib_call_ms = time_ms(torch, sdpa_bwd(torch, q, k, v, do, causal))
        except RuntimeError as e:       # a torch whose flash op this card or graph refuses
            log(f"time flash_bwd {what}: SDPA's backward op not timed: {e}")
            lib_ms = lib_call_ms = None
    bound = flash_bwd_bound(q, k, causal, window=window)
    lib_op = "efficient" if f32 else "flash"
    res = {"shape": list(q.shape) + [k.shape[2]], "dtype": str(q.dtype).split(".")[1],
           "causal": causal, "window": window, "ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_call_ms": lib_call_ms, "library_eager_ms": lib_eager,
           "bound_ms": bound[0], "bound_by": bound[1], "err_over_limit": ratio,
           "plain_f32_err_vs_f64": plain_err,
           "plain_f32_err_over_limit": plain_err / F32_TOL if f32 else None,
           "bound_simt_ms": flash_bwd_bound(q, k, causal, PEAK_F32_FLOPS, window)[0]
           if f32 else None,
           "by_kernel": device_ms_by_kernel(torch, run),
           "plain": "autograd backward, eager (CUDA events)",
           "library": f"aten._scaled_dot_product_{lib_op}_attention_backward by CUDA-graph "
                      "replay (K, V repeated to H heads); library_eager_ms: SDPA's "
                      "autograd backward, eager" if window is None else
                      "SDPA's autograd backward with the window as a boolean mask, eager"}
    log(f"time flash_bwd {what}: {res}")
    return res


def flash_bound(q, k, causal, lse, peak=None, window=None):
    """(bound ms, what bounds it) of a flash forward: 4 D flops per
    unmasked (query, key) pair and head at ``peak`` (default
    ``_flash_peak``), q, k, v read and o (and the f32 lse) written once in
    the inputs' dtype."""
    B, S, H, D = q.shape
    pairs = attn_pairs(S, causal, window)
    nbytes = q.element_size() * B * S * D * (2 * H + 2 * k.shape[2]) \
        + (4 * B * H * S if lse else 0)
    return _bound(4 * B * H * D * pairs, nbytes, peak or _flash_peak(q))


def time_kernels(torch, rec, strict=True):
    """Phase ``time``.  ``strict``: a timed input outside the kernel gate
    fails the run; otherwise (another build, ``--against``) its reading is
    logged and kept."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention_fwd

    def checked(what, reading):   # the timed inputs are held to the kernel gate first
        err, ratio = reading
        log(f"time {what}: max_abs_err {err:.3e}, error/limit {ratio:.3f}")
        if strict and not ratio <= 1.0:
            fail(f"time {what}: error {err} is {ratio:.3f} x its limit")
        return ratio

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    H, Hkv, D = 24, 2, 128
    flash = []
    for S in (128, 256, 512, 1024):
        q = torch.randn(1, S, H, D, generator=gen, device="cuda").to(bf)
        k = torch.randn(1, S, Hkv, D, generator=gen, device="cuda").to(bf)
        v = torch.randn(1, S, Hkv, D, generator=gen, device="cuda").to(bf)
        ratio = checked(f"flash S={S}", flash_reading(torch, q, k, v, True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms, call_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True))
        plain_ms, plain_call_ms = time_ms(
            torch, lambda: ref.flash_attention_ref(q, k, v, causal=True))
        lib_ms, lib_call_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound = flash_bound(q, k, causal=True, lse=False)
        flash.append({
            "S": S, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "library_call_ms": lib_call_ms, "err_over_limit": ratio})
        log(f"time flash S={S}: {flash[-1]}")
    # paged: 8 slots x ~1000 live tokens; 8 disjoint table sets cycle so the
    # 66 MB they cover exceeds the 50 MB L2, as a decode tick's 30 layers do
    B, P, maxp, R = 8, 16, 64, 8
    NP = 1 + R * B * maxp
    kp = torch.randn(NP, P, Hkv, D, generator=gen, device="cuda").to(bf)
    vp = torch.randn(NP, P, Hkv, D, generator=gen, device="cuda").to(bf)
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(bf)
    pos = torch.tensor([1000 - 7 * b for b in range(B)], dtype=torch.int32, device="cuda")
    ids = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(3)) + 1
    tables = [ids[r * B * maxp:(r + 1) * B * maxp].reshape(B, maxp).int().cuda()
              for r in range(R)]
    live = int((pos + 1).sum())
    nbytes = live * 2 * Hkv * D * 2 + 2 * q.numel() * 2 + B * (maxp + 1) * 4
    flops = 4 * H * D * live
    ratio = max(checked(f"paged table set {r}", paged_reading(torch, q, kp, vp, tables[r], pos))
                for r in range(R))
    it = iter(range(10**9))
    run = lambda: paged_attention_fwd(q, kp, vp, tables[next(it) % R], pos)
    ms, call_ms = time_ms(torch, run)
    plain_ms, plain_call_ms = time_ms(torch, lambda: ref.paged_attention_ref(
        q, kp, vp, tables[next(it) % R], pos))
    paged = {
        "live_tokens": live, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
        "call_ms": call_ms, "plain_call_ms": plain_call_ms, "err_over_limit": ratio,
        "by_kernel": device_ms_by_kernel(torch, run)}
    # the host's cost of one call: eager calls at one slot of one page,
    # where the device takes a few microseconds
    one = (q[:1], kp[:2], vp[:2], tables[0][:1, :1].clamp(max=1), pos[:1].clamp(max=P - 1))
    paged["host_call_ms"] = eager_ms(torch, lambda: paged_attention_fwd(*one), iters=50, warm=5)
    log(f"time paged: {paged}")
    rec["time"] = {"flash": flash, "paged": paged, "ssd": time_ssd(torch, checked, gen),
                   "ssd_bwd": time_ssd_bwd(torch, checked, gen),
                   **time_train_kernels(torch, checked, gen),
                   "gemma": time_gemma_kernels(torch, checked, gen)}


def time_gemma_kernels(torch, checked, gen, iters=5, reps=3):
    """gemma3-4b's attention kernels at head dim 256, causal: the flash
    forward at a 2048-token serve prefill in bf16, with the local layers'
    window of 1024 and without; forward (with lse) and backward at the
    gemma_train shape (B 4 x S 2048) in bf16 and f32, window and none; the
    paged decode of its global layers, 8 slots of about 2000 tokens, in
    bf16.  SDPA (enable_gqa; the window as an explicit boolean mask) is
    the yardstick.  Fewer graph replays than the small shapes take."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention_fwd

    def fwd_row(what, q, k, v, window, lse):
        ratio = checked(f"flash {what}", flash_reading(torch, q, k, v, True, window))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None if window is None else window_mask(torch, q.shape[1], window, q.device)
        run = lambda: flash_attention_fwd(q, k, v, causal=True, window=window, return_lse=lse)
        ms, call_ms = time_ms(torch, run, iters, reps)
        plain_ms, _ = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=True, window=window), iters, reps)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                     is_causal=mask is None, enable_gqa=True)
        try:
            lib_ms, _ = time_ms(torch, lib, iters, reps)
        except RuntimeError as e:   # a torch whose masked SDPA a graph refuses: eager
            log(f"time flash {what}: SDPA not captured in a graph ({e}); timed eager")
            lib_ms = eager_ms(torch, lib, iters)
        b = flash_bound(q, k, True, lse=lse, window=window)
        row = {"shape": list(q.shape) + [k.shape[2]], "dtype": str(q.dtype).split(".")[1],
               "window": window, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b[0], "bound_by": b[1], "err_over_limit": ratio,
               "library": "SDPA" + (" with the window as a boolean mask" if window else "")}
        log(f"time flash {what}: {row}")
        return row

    mk = lambda shape, dtype: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    out = {"flash_serve": [], "flash_train": {}}
    B, S, H, Hkv, D, _ = GEMMA_SERVE_ATTN
    q, k, v = mk((B, S, H, D), torch.bfloat16), *(mk((B, S, Hkv, D), torch.bfloat16)
                                                  for _ in range(2))
    for window in (GEMMA_WINDOW, None):
        out["flash_serve"].append(fwd_row(f"gemma serve window={window}", q, k, v, window,
                                          False))
    B, S, H, Hkv, D, _ = GEMMA_TRAIN_ATTN
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        q, do = (mk((B, S, H, D), dtype) for _ in range(2))
        k, v = (mk((B, S, Hkv, D), dtype) for _ in range(2))
        for window in (GEMMA_WINDOW, None):
            what = f"gemma train {dname} window={window}"
            out["flash_train"].setdefault(dname, {})["window" if window else "global"] = {
                "fwd": fwd_row(what, q, k, v, window, True),
                "bwd": time_flash_bwd(torch, checked, what, q, k, v, do, True, window, iters,
                                      reps)}
        del q, k, v, do
    # paged: the global layers' decode tick, 8 slots x ~2000 live tokens;
    # two disjoint table sets alternate, 67 MB of K/V each (L2: 50 MB)
    B, H, Hkv, D, P, maxp, R = 8, 8, 4, 256, 16, 128, 2
    NP = 1 + R * B * maxp
    kp, vp = (mk((NP, P, Hkv, D), torch.bfloat16) for _ in range(2))
    q = mk((B, H, D), torch.bfloat16)
    pos = torch.tensor([2000 - 9 * b for b in range(B)], dtype=torch.int32, device="cuda")
    ids = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(4)) + 1
    tables = [ids[r * B * maxp:(r + 1) * B * maxp].reshape(B, maxp).int().cuda()
              for r in range(R)]
    live = int((pos + 1).sum())
    nbytes = live * 2 * Hkv * D * 2 + 2 * q.numel() * 2 + B * (maxp + 1) * 4
    b = _bound(4 * H * D * live, nbytes, PEAK_BF16_FLOPS)
    ratio = max(checked(f"paged gemma table set {r}",
                        paged_reading(torch, q, kp, vp, tables[r], pos)) for r in range(R))
    it = iter(range(10**9))
    run = lambda: paged_attention_fwd(q, kp, vp, tables[next(it) % R], pos)
    ms, call_ms = time_ms(torch, run)
    plain_ms, _ = time_ms(torch, lambda: ref.paged_attention_ref(
        q, kp, vp, tables[next(it) % R], pos))
    out["paged"] = {"shape": [B, H, Hkv, D, P], "live_tokens": live, "ms": ms,
                    "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": b[0], "bound_by": b[1], "err_over_limit": ratio,
                    "by_kernel": device_ms_by_kernel(torch, run)}
    log(f"time paged gemma: {out['paged']}")
    return out


def ssd_work(B, S, H, P, G, N, L, es):
    """(flops, bytes) the SSD scan needs: per (batch, head, chunk) C.state,
    the masked product of C B^T with x over the causal triangle and B^T x,
    and C B^T over the triangle once per (batch, group, chunk), the last
    chunk cut to S; each input read once (x, B, C at ``es`` bytes, dt and
    A f32) and each output written once (y at ``es``, the f32 state)."""
    per_head = per_group = 0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        tri = n * (n + 1) // 2
        per_head += 2 * (n * N * P + tri * P + N * n * P)
        per_group += 2 * tri * N
    nbytes = es * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * (B * S * H + H + B * H * N * P)
    return per_head * B * H + per_group * B * G, nbytes


def time_ssd(torch, checked, gen):
    """ssd_scan at mamba2-130m's prefill of 1024 tokens (B 1, H 24, P 64,
    G 1, N 128, chunk 256), in bf16 (the serve path's dtype) and f32, in
    bf16 at zamba2-2.7b's (H 80, N 64), and in f32 at mamba2-130m's train
    shape (MAMBA2_TRAIN, the CLI's dtype; no plain timing there, the
    plain version is no yardstick of speed).  f32 bounds at the split
    peak, PEAK_F32_SPLIT_FLOPS, with the CUDA cores' beside it
    (``bound_simt_ms``).  No PyTorch call computes SSD: no library
    yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd

    mamba2, zamba2 = SSD_CASES[0], next(c for c in SSD_CASES if c[2] == 80)
    train = (*MAMBA2_TRAIN, 1.0, False)
    out = {}
    for key, case, dname, peak in (("bfloat16", mamba2, "bfloat16", PEAK_BF16_FLOPS),
                                   ("float32", mamba2, "float32", PEAK_F32_SPLIT_FLOPS),
                                   ("zamba2_bf16", zamba2, "bfloat16", PEAK_BF16_FLOPS),
                                   ("float32_train", train, "float32", PEAK_F32_SPLIT_FLOPS)):
        dtype = getattr(torch, dname)
        x, dt, A, Bm, Cm = _ssd_inputs(torch, case, dtype, gen)
        ratio = checked(f"ssd_scan {key}", ssd_reading(torch, x, dt, A, Bm, Cm, case[6]))
        run = lambda: ssd_scan_fwd(x, dt, A, Bm, Cm, case[6])
        ms, call_ms = time_ms(torch, run)
        plain_ms = plain_call_ms = None
        if key != "float32_train":
            plain_ms, plain_call_ms = time_ms(torch, lambda: ref.ssd_ref(x, dt, A, Bm, Cm, case[6]))
        flops, nbytes = ssd_work(*case[:7], x.element_size())
        bound = _bound(flops, nbytes, peak)
        out[key] = {"shape": list(case[:7]), "dtype": dname, "ms": ms, "call_ms": call_ms,
                    "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
                    "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1],
                    "err_over_limit": ratio, "by_kernel": device_ms_by_kernel(torch, run)}
        if dname == "float32":
            out[key].update({"bound_simt_ms": _bound(flops, nbytes, PEAK_F32_FLOPS)[0],
                             "bound_ops_ms": flops / peak * 1e3,
                             "bound_bytes_ms": nbytes / PEAK_BYTES * 1e3,
                             "flops": flops, "bytes": nbytes})
        log(f"time ssd_scan {key}: {out[key]}")
        del x, dt, A, Bm, Cm
    return out


def ssd_bwd_work(B, S, H, P, G, N, L, es):
    """(flops, bytes) the SSD scan's backward needs: per (batch, head,
    chunk of n steps) five products over (n, N, P) (the chunk's state
    update U and V_c = sum exp(acs_l) C_l gy_l^T, B dS, dS x, S gy), and
    over the n (n + 1) / 2 causal pairs gy x^T and M^T gy (P each); per
    (batch, group, chunk) over the pairs C B^T and the weighted sums for
    dB and dC (N each), which are linear in the pair weights and so need
    them summed over the group's heads only once; each input read once
    (x, gy, B, C at ``es`` bytes, dt, A and gstate f32) and each gradient
    written once (dx, dB, dC at ``es``, ddt and dA f32)."""
    per_head = per_group = 0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        tri = n * (n + 1) // 2
        per_head += 2 * (5 * n * N * P + tri * 2 * P)
        per_group += 2 * tri * 3 * N
    nbytes = es * (3 * B * S * H * P + 4 * B * S * G * N) \
        + 4 * (2 * B * S * H + 2 * H + B * H * N * P)
    return per_head * B * H + per_group * B * G, nbytes


def time_ssd_bwd(torch, checked, gen):
    """The backward kernel at mamba2-130m's train shape (MAMBA2_TRAIN, a
    zero gstate as in train mode) in f32 (the CLI's) and bf16, against
    its bound (by operations and by bytes: bf16 at the bf16 peak, f32 on
    three pieces at a sixth of it, PEAK_F32_SPLIT_FLOPS, with the CUDA
    cores' f32 bound beside it as ``bound_simt_ms``) and the plain
    version's autograd (eager).  No PyTorch call computes it: no library
    yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    out = {}
    for dname, peak in (("float32", PEAK_F32_SPLIT_FLOPS), ("bfloat16", PEAK_BF16_FLOPS)):
        dtype = getattr(torch, dname)
        case = (*MAMBA2_TRAIN, False)
        ins = _ssd_bwd_inputs(torch, case, dtype, gen)
        chunk = case[6]
        ratio = checked(f"ssd_scan_bwd {dname}", ssd_bwd_reading(torch, *ins, chunk))
        run = lambda: ssd_scan_bwd(*ins, chunk)
        ms, call_ms = time_ms(torch, run)
        xs = [t.detach().requires_grad_(True) for t in ins[:5]]
        with torch.enable_grad():
            outs = ref.ssd_ref(*xs, chunk)
        plain_ms = eager_ms(torch, lambda: torch.autograd.grad(outs, xs, ins[5:],
                                                               retain_graph=True), iters=5)
        del outs, xs
        flops, nbytes = ssd_bwd_work(*MAMBA2_TRAIN, ins[0].element_size())
        bound = _bound(flops, nbytes, peak)
        out[dname] = {"shape": list(MAMBA2_TRAIN), "dtype": dname, "ms": ms, "call_ms": call_ms,
                      "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound[0],
                      "bound_by": bound[1], "bound_ops_ms": flops / peak * 1e3,
                      "bound_bytes_ms": nbytes / PEAK_BYTES * 1e3, "flops": flops,
                      "bound_simt_ms": _bound(flops, nbytes, PEAK_F32_FLOPS)[0]
                      if dname == "float32" else None,
                      "bytes": nbytes, "err_over_limit": ratio,
                      "by_kernel": device_ms_by_kernel(torch, run),
                      "plain": "autograd backward of ref.ssd_ref, eager (CUDA events)"}
        log(f"time ssd_scan_bwd {dname}: {out[dname]}")
    return out


def time_flash_train(torch, checked, gen, dtype, what):
    """Flash forward and backward at bert-mlm-120m's attention (BERT_ATTN)
    in ``dtype``: the gate on the timed inputs, then each timed against
    its bound, the plain version and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    B, S, H, _, D, causal = BERT_ATTN
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    r_fwd = checked(f"flash {what}", flash_reading(torch, q, k, v, causal))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd_ms, fwd_call = time_ms(
        torch, lambda: flash_attention_fwd(q, k, v, causal=causal, return_lse=True))
    fwd_nolse, _ = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=causal))
    fwd_plain, _ = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=causal))
    fwd_lib, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      is_causal=causal))
    fwd_b = flash_bound(q, k, causal=causal, lse=True)
    res = {
        "shape": [B, S, H, D], "dtype": str(dtype).split(".")[1], "causal": causal,
        "fwd": {"ms": fwd_ms, "ms_without_lse": fwd_nolse, "call_ms": fwd_call,
                "plain_ms": fwd_plain, "library_ms": fwd_lib,
                "bound_ms": fwd_b[0], "bound_by": fwd_b[1], "err_over_limit": r_fwd,
                "bound_simt_ms": flash_bound(q, k, causal, True, PEAK_F32_FLOPS)[0]
                if dtype == torch.float32 else None,
                "by_kernel": device_ms_by_kernel(
                    torch, lambda: flash_attention_fwd(q, k, v, causal=causal, return_lse=True))},
        "bwd": time_flash_bwd(torch, checked, what, q, k, v, do, causal)}
    log(f"time flash {what}: {res['fwd']}")
    return res, (q, k, v, do)


def time_train_kernels(torch, checked, gen, T=3904, V=32768):
    """The train phases' kernels at their shapes: flash forward and
    backward at bert-mlm-120m's attention (BERT_ATTN, non-causal) in bf16
    and in f32 (the train_cli phase's dtype, on the f32 bodies: three bf16
    pieces on wgmma), fused_xent forward and backward on one loss chunk (32 x 122 rows of 32768 logits)
    in f32, the train path's dtype, and in bf16; the flash backward also
    at starcoder2-3b's attention (GQA 24 / 2, D 128, causal, S 1024).
    Library yardsticks: SDPA and its backward op, F.cross_entropy and its
    autograd backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.fused_xent import fused_xent_bwd, fused_xent_fwd

    out = {}
    bf = torch.bfloat16
    out["flash_train_f32"], _ = time_flash_train(torch, checked, gen, torch.float32,
                                                 "train shape f32")
    out["flash_train"], (q, k, v, do) = time_flash_train(torch, checked, gen, bf, "train shape")
    # the host's cost of one backward call: eager calls at (1, 128, 12, 64),
    # where the device takes about 0.01 ms
    qs, ks, vs, dos = (x[:1, :128] for x in (q, k, v, do))
    os_, lse_s = flash_attention_fwd(qs, ks, vs, causal=False, return_lse=True)
    out["flash_train"]["bwd"]["host_call_ms"] = eager_ms(
        torch, lambda: flash_attention_bwd(qs, ks, vs, os_, lse_s, dos, causal=False),
        iters=50, warm=5)
    log(f"time flash_bwd host cost of a call: {out['flash_train']['bwd']['host_call_ms']} ms")
    out["flash_bwd_window_d64"] = time_flash_bwd(
        torch, checked, f"train shape causal window={WINDOW_TIMED[64]}", q, k, v, do, True,
        WINDOW_TIMED[64])
    # the serve shape (starcoder2-3b's attention at S 1024), whose kv heads
    # give the dkdv pass only 16 blocks
    q, do = (torch.randn(1, 1024, 24, 128, generator=gen, device="cuda").to(bf)
             for _ in range(2))
    k, v = (torch.randn(1, 1024, 2, 128, generator=gen, device="cuda").to(bf) for _ in range(2))
    out["flash_bwd_gqa"] = time_flash_bwd(torch, checked, "gqa causal", q, k, v, do, True)
    out["flash_bwd_gqa_window"] = time_flash_bwd(
        torch, checked, f"gqa causal window={WINDOW_TIMED[128]}", q, k, v, do, True,
        WINDOW_TIMED[128])
    del q, k, v, do, qs, ks, vs, dos, os_, lse_s
    out["xent"] = {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        logits, labels, g = _xent_inputs(torch, (T, V), dtype, gen)
        rf, rb = (checked(f"{w} {dname}", r) for w, r in
                  zip(("fused_xent", "fused_xent_bwd"), xent_readings(torch, logits, labels, g)))
        labels64 = labels.long()
        nll, lse = fused_xent_fwd(logits, labels)
        f_ms, f_call = time_ms(torch, lambda: fused_xent_fwd(logits, labels))
        f_plain, _ = time_ms(torch, lambda: ref.xent_ref(logits, labels))
        f_lib, _ = time_ms(torch, lambda: F.cross_entropy(logits, labels64, reduction="none"))
        b_ms, b_call = time_ms(torch, lambda: fused_xent_bwd(logits, labels, lse, g))
        x = logits.detach().requires_grad_(True)
        with torch.enable_grad():
            y_plain = ref.xent_ref(x, labels)
            y_lib = F.cross_entropy(x, labels64, reduction="none")
        b_plain = eager_ms(torch, lambda: torch.autograd.grad(y_plain, x, g, retain_graph=True))
        b_lib = eager_ms(torch, lambda: torch.autograd.grad(
            y_lib, x, g.to(y_lib.dtype), retain_graph=True))
        es = logits.element_size()
        fb = _bound(4 * T * V, T * V * es + 3 * T * 4, PEAK_F32_FLOPS)
        bb = _bound(4 * T * V, 2 * T * V * es + 3 * T * 4, PEAK_F32_FLOPS)
        out["xent"][dname] = {
            "T": T, "V": V,
            "fwd": {"ms": f_ms, "call_ms": f_call, "plain_ms": f_plain, "library_ms": f_lib,
                    "bound_ms": fb[0], "bound_by": fb[1], "err_over_limit": rf},
            "bwd": {"ms": b_ms, "call_ms": b_call, "plain_ms": b_plain, "library_ms": b_lib,
                    "bound_ms": bb[0], "bound_by": bb[1], "err_over_limit": rb,
                    "plain_and_library": "autograd backward, eager (CUDA events)"}}
        log(f"time xent {dname}: {out['xent'][dname]}")
        del x, y_plain, y_lib, logits
    return out


def kernel_records(rec):
    """One record per kernel.  ``launches``: the main paths' runs (serve,
    ssm_serve, train, train_cli's run (a) and rank 0 of ddp's run (a)),
    each counted from 0 just before it; the times are those of
    the shape each path runs (flash forward: the serve prefill at S=1024,
    with bert's shape under ``train_shape``; flash backward: bert's shape,
    starcoder2-3b's under ``gqa_causal_shape``; both flash kernels at
    bert's shape in f32, the train_cli path's, under ``train_shape_f32``,
    with its bound at PEAK_F32_SPLIT_FLOPS and, as ``bound_simt_ms``, at
    the CUDA cores' f32 peak; fused_xent: the f32 logits
    the train path feeds it, with bf16 under ``bf16``; ssd_scan: the bf16
    prefill at S=1024, with f32 under ``f32`` and f32 at mamba2-130m's
    train shape under ``f32_train_shape``; its backward: mamba2-130m's
    train shape in f32, the CLI's, with bf16 under ``bf16``).  The
    ssm_train path's launches are run (a)'s, the CLI's; run (c)'s, bf16 at
    microbatch 2, are under ``ssm_train_bf16``."""
    errs = rec.get("errors", {})
    t = rec.get("time", {})
    paths = {key: rec.get(key, {}).get("launches", {})
             for key in ("serve", "ssm_serve", "train", "train_cli", "ssm_train", "ddp",
                         "gemma_serve", "gemma_train")}
    paths["ssm_train_bf16"] = rec.get("ssm_train", {}).get("c", {}).get("launches", {})
    paths["gemma_train_bf16"] = rec.get("gemma_train", {}).get("b", {}).get("launches", {})
    gm = t.get("gemma", {})
    gtrain = gm.get("flash_train", {})      # {dtype: {"window" | "global": {fwd, bwd}}}
    flash_top = next((x for x in t.get("flash", []) if x["S"] == 1024), {})
    ft, xe = t.get("flash_train", {}), t.get("xent", {})
    ft32 = t.get("flash_train_f32", {})
    ssd, ssd_bwd = t.get("ssd", {}), t.get("ssd_bwd", {})
    bwd = ft.get("bwd", {})
    extra = {"flash_attention": {"train_shape": ft.get("fwd"),
                                 "train_shape_f32": ft32.get("fwd"),
                                 "gemma_serve_shape": gm.get("flash_serve"),
                                 "gemma_train_shape": {d: {k: r.get("fwd") for k, r in v.items()}
                                                       for d, v in gtrain.items()}},
             "paged_attention": {**{k: t.get("paged", {}).get(k)
                                    for k in ("call_ms", "host_call_ms", "by_kernel")},
                                 "gemma_shape": gm.get("paged")},
             "flash_attention_bwd": {"call_ms": bwd.get("call_ms"),
                                     "host_call_ms": bwd.get("host_call_ms"),
                                     "library_eager_ms": bwd.get("library_eager_ms"),
                                     "by_kernel": bwd.get("by_kernel"),
                                     "gqa_causal_shape": t.get("flash_bwd_gqa"),
                                     "gqa_causal_window_shape": t.get("flash_bwd_gqa_window"),
                                     "train_shape_causal_window": t.get("flash_bwd_window_d64"),
                                     "train_shape_f32": ft32.get("bwd"),
                                     "gemma_train_shape": {d: {k: r.get("bwd")
                                                               for k, r in v.items()}
                                                           for d, v in gtrain.items()}},
             "fused_xent": {"bf16": xe.get("bfloat16", {}).get("fwd")},
             "fused_xent_bwd": {"bf16": xe.get("bfloat16", {}).get("bwd")},
             "ssd_scan": {"f32": ssd.get("float32"), "zamba2_bf16": ssd.get("zamba2_bf16"),
                          "f32_train_shape": ssd.get("float32_train")},
             "ssd_scan_bwd": {"bf16": ssd_bwd.get("bfloat16"),
                              "bound_simt_ms": ssd_bwd.get("float32", {}).get("bound_simt_ms"),
                              "bound_ops_ms": ssd_bwd.get("float32", {}).get("bound_ops_ms"),
                              "bound_bytes_ms": ssd_bwd.get("float32", {}).get("bound_bytes_ms")}}
    csrc = "src/repro_torch/kernels/csrc/"
    out = []
    for name, src, replaces, timing in (
            ("flash_attention", csrc + "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:85", flash_top),
            ("flash_attention_bwd", csrc + "flash_attention_bwd.cu",
             "src/repro/kernels/ops.py:44", bwd),
            ("paged_attention", csrc + "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:91", t.get("paged", {})),
            ("fused_xent", csrc + "fused_xent.cu",
             "src/repro/kernels/fused_xent.py:52", xe.get("float32", {}).get("fwd", {})),
            ("fused_xent_bwd", csrc + "fused_xent.cu",
             "src/repro/kernels/ops.py:111", xe.get("float32", {}).get("bwd", {})),
            ("ssd_scan", csrc + "ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:74", ssd.get("bfloat16", {})),
            ("ssd_scan_bwd", csrc + "ssd_scan_bwd.cu",
             "src/repro/kernels/ops.py:87", ssd_bwd.get("float32", {}))):
        e = errs.get(name, {})
        by_path = {p: c[name] for p, c in paths.items() if c.get(name)}
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()) if by_path else None,
            "launches_by_path": by_path, **extra.get(name, {}),
            "max_abs_err": max(x["max_abs_err"] for x in e.values()) if e else None,
            "max_err_f32": e.get("float32", {}).get("max_abs_err"),
            "max_err_bf16": e.get("bfloat16", {}).get("max_abs_err"),
            "bf16_err_over_limit": e.get("bfloat16", {}).get("max_ratio"),
            "ms": timing.get("ms"), "plain_ms": timing.get("plain_ms"),
            "bound_ms": timing.get("bound_ms"), "bound_by": timing.get("bound_by"),
            "library_ms": timing.get("library_ms")})
    return out


def summary(rec):
    """The run's end-to-end and check readings in one short line (the
    details are in chiprun_out/chip_smoke.json)."""
    sv, prof = rec.get("serve", {}), rec.get("serve_decode_profile", {})
    ssm, sprof = rec.get("ssm_serve", {}), rec.get("ssm_serve_decode_profile", {})
    keys = ("tokens_per_s", "ttft_p50_ms", "decode_tick_p50_ms", "decode_ticks")
    tr, tprof = rec.get("train", {}), rec.get("train", {}).get("profile", {})
    tkeys = ("step_time_p50_ms", "tokens_per_s", "mfu", "first_loss", "last_loss",
             "launches_per_step")
    return {"build_s": rec.get("build_s"), "seconds": rec.get("seconds"),
            "phase_s": rec.get("phase_s"),
            "serve": {k: sv.get(k) for k in keys},
            "tick_device_busy_ms": prof.get("device_busy_ms"),
            "tick_repo_kernels_ms": prof.get("ms_per_tick_by_class", {}).get("repo kernels"),
            "tick_launches": prof.get("kernel_launches_per_tick"),
            "prefill_1024_device_busy_ms":
                rec.get("serve_prefill_profile", {}).get("device_busy_ms"),
            "ssm_serve": {k: ssm.get(k) for k in keys},
            "ssm_tick_device_busy_ms": sprof.get("device_busy_ms"),
            "ssm_prefill_1024_device_busy_ms":
                rec.get("ssm_serve_prefill_profile", {}).get("device_busy_ms"),
            "ssm_prefill_1024_repo_kernels_ms": rec.get("ssm_serve_prefill_profile", {}).get(
                "ms_by_class", {}).get("repo kernels"),
            "train": {k: tr.get(k) for k in tkeys},
            "train_step_device_busy_ms": tprof.get("device_busy_ms"),
            "train_cli": {k: rec.get("train_cli", {}).get(k) for k in (
                "step_time_p50_ms", "tokens_per_s", "mfu", "data_wait_share", "autotune",
                "ckpt_host_copy_ms", "ckpt_write_ms", "first_loss", "last_loss",
                "resume_bit_exact")},
            "train_cli_step_device_busy_ms":
                rec.get("train_cli", {}).get("profile", {}).get("device_busy_ms"),
            "train_step_launches": tprof.get("kernel_launches_per_step"),
            "ssm_train": {k: rec.get("ssm_train", {}).get(k) for k in (
                "step_time_p50_ms", "tokens_per_s", "mfu", "first_loss", "last_loss",
                "resume_bit_exact")},
            "ssm_train_bf16_p50_ms": rec.get("ssm_train", {}).get("c", {}).get("step_time_p50_ms"),
            "ssm_train_step_device_busy_ms": rec.get("ssm_train", {}).get("a", {}).get(
                "profile", {}).get("device_busy_ms"),
            "ssm_train_bf16_step_device_busy_ms": rec.get("ssm_train", {}).get("c", {}).get(
                "profile", {}).get("device_busy_ms"),
            "ssm_train_path_rel_err": rec.get("ssm_train_path", {}).get("rel_err"),
            "gemma_path_max_rel_err": rec.get("gemma_path", {}).get("max_rel_err"),
            "gemma_serve": {k: rec.get("gemma_serve", {}).get(k) for k in keys},
            "gemma_tick_device_busy_ms":
                rec.get("gemma_serve_decode_profile", {}).get("device_busy_ms"),
            "gemma_prefill_2048_device_busy_ms":
                rec.get("gemma_serve_prefill_profile", {}).get("device_busy_ms"),
            "gemma_train_path_rel_err": rec.get("gemma_train_path", {}).get("rel_err"),
            "gemma_train": {tag: {k: rec.get("gemma_train", {}).get(tag, {}).get(k) for k in (
                "step_time_p50_ms", "tokens_per_s", "mfu")} | {
                "device_busy_ms": rec.get("gemma_train", {}).get(tag, {}).get(
                    "profile", {}).get("device_busy_ms")} for tag in ("a", "b")},
            "ddp": {k: rec.get("ddp", {}).get(k) for k in (
                "step_time_p50_ms", "global_tokens_per_s", "traj_max_rel_err",
                "resume_bit_exact")},
            "ddp_profile": [{k: p.get(k) for k in ("step_p50_ms", "exposed_sync_ms")} |
                            {"device_busy_ms": p.get("profile", {}).get("device_busy_ms")}
                            for p in rec.get("ddp", {}).get("profile", [])],
            "ddp_path_max_rel_err": {name: max((g[name]["max_rel_err"] for r in rec.get(
                "ddp_path", {}).get("ranks", []) for g in r["grads"].values()), default=None)
                for name in ("shards", "batch")},
            "path_max_rel_err": rec.get("path", {}).get("max_rel_err"),
            "ssm_path_max_rel_err": rec.get("ssm_path", {}).get("max_rel_err"),
            "train_path_rel_err": rec.get("train_path", {}).get("rel_err"),
            "faults_max_ratio": [[f["kernel"], f["max_ratio"]] for f in rec.get("faults", [])],
            "flash_ms_by_S": {x["S"]: x["ms"] for x in rec.get("time", {}).get("flash", [])},
            "flash_train_ms": rec.get("time", {}).get("flash_train", {}).get("fwd", {}).get("ms"),
            "flash_bwd_train_ms":
                rec.get("time", {}).get("flash_train", {}).get("bwd", {}).get("ms"),
            "flash_train_f32_ms":
                rec.get("time", {}).get("flash_train_f32", {}).get("fwd", {}).get("ms"),
            "flash_bwd_train_f32_ms":
                rec.get("time", {}).get("flash_train_f32", {}).get("bwd", {}).get("ms"),
            "flash_bwd_gqa_ms": rec.get("time", {}).get("flash_bwd_gqa", {}).get("ms"),
            "flash_bwd_window_ms": {k: rec.get("time", {}).get(k, {}).get("ms") for k in (
                "flash_bwd_window_d64", "flash_bwd_gqa_window")},
            "paged_ms": rec.get("time", {}).get("paged", {}).get("ms"),
            "ssd_ms": {k: v["ms"] for k, v in rec.get("time", {}).get("ssd", {}).items()},
            "ssd_bwd_ms": {k: v["ms"] for k, v in rec.get("time", {}).get("ssd_bwd", {}).items()}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--against", action="append", default=[], metavar="NAME=SOURCE",
                    help="also run phases serve, ssm_serve, train and time with SOURCE's "
                         "build of the kernel its file name names")
    ap.add_argument("--ddp-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ddp-spec", default="{}", help=argparse.SUPPRESS)
    ap.add_argument("--cpu-ref", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        fail(f"unknown phase in {phases}; phases are {PHASES}")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    if args.cpu_ref:            # the cpu side of a next-token check
        cpu_ref_worker(torch, args.cpu_ref)
        return
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 phases in full f32
    torch.backends.cudnn.allow_tf32 = False
    if args.ddp_worker:         # one rank of a spawn_ddp run
        ddp_worker(torch, args.ddp_worker, json.loads(args.ddp_spec))
        return
    card = gpu_line()
    log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    rec = {"gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    t_all = time.perf_counter()
    atexit.register(stop_children)
    cpu_refs = start_cpu_refs(phases)

    from repro_torch.kernels import _build

    against = parse_against(args.against)
    against_builds = start_against_builds(against)
    t0 = time.perf_counter()
    _build.build_all()
    rec["build_s"] = time.perf_counter() - t0
    log(f"build: {rec['build_s']:.1f}s")
    fault_builds = start_fault_builds() if "faults" in phases else None
    rec["ptxas"] = {name: ptxas_report(text) for name, text in _build.build_log.items()}
    for name, report in rec["ptxas"].items():
        for fn, lines in report.items():
            for line in lines:
                if fn == "warnings" or ("spill" in line and
                                        "0 bytes spill stores, 0 bytes spill loads" not in line):
                    log(f"ptxas {name} {fn}: {line}")
    rec["build_log"] = _build.build_log
    wgmma_build_facts(rec)
    against_libs = load_against(rec, against, against_builds)
    steps = {"kernels": check_kernels,
             "faults": lambda torch, rec: check_faults(torch, rec, fault_builds),
             "path": check_path, "serve": run_serve, "ssm_path": check_ssm_path,
             "ssm_serve": lambda torch, rec: run_serve(torch, rec, arch="mamba2-130m",
                                                       key="ssm_serve"),
             "train_path": check_train_path,
             "train": run_train, "train_cli": run_train_cli,
             "ssm_train_path": lambda torch, rec: check_lm_train_path(
                 torch, rec, "ssm_train_path", cpu_refs),
             "ssm_train": run_ssm_train,
             "gemma_path": check_gemma_path, "gemma_serve": run_gemma_serve,
             "gemma_train_path": lambda torch, rec: check_lm_train_path(
                 torch, rec, "gemma_train_path", cpu_refs),
             "gemma_train": run_gemma_train,
             "ddp_path": check_ddp_path,
             "ddp": run_ddp, "time": time_kernels}
    for ph in PHASES[1:]:
        if ph in phases:
            t0 = time.perf_counter()
            if against_libs and ph in AGAINST_PHASES:
                run_against(torch, rec, ph, steps[ph], against_libs)
            else:
                steps[ph](torch, rec)
            rec.setdefault("phase_s", {})[ph] = time.perf_counter() - t0
            log(f"phase {ph}: {rec['phase_s'][ph]:.1f}s")
    rec["seconds"] = time.perf_counter() - t_all
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(rec, indent=1))
    log(f"summary: {json.dumps(summary(rec))}")
    print(json.dumps({"kernels": kernel_records(rec)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

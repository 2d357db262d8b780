#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,train_path,train
    python3 chip_smoke.py --phases build,ssm_path,ssm_serve
    python3 chip_smoke.py --phases build,train_cli
    python3 chip_smoke.py --phases build,ddp_path,ddp
    python3 chip_smoke.py --phases build,ddp_path,fsdp_path,ddp,fsdp
    python3 chip_smoke.py --phases build,ssm_train_path,ssm_train
    python3 chip_smoke.py --phases build,gemma_path,gemma_serve,gemma_train_path,gemma_train
    python3 chip_smoke.py --phases build,gemma2_path,gemma2_serve,gemma2_train_path,gemma2_train
    python3 chip_smoke.py --phases build,zamba2_path,zamba2_serve,zamba2_train_path,zamba2_train
    python3 chip_smoke.py --phases build,qwen2_path,llama3_train_path,llama3_serve,llama3_train
    python3 chip_smoke.py --phases build,bert350_train,bert_max_batch
    python3 chip_smoke.py --phases build,mixtral_path,phi35_path,mixtral_train_path,mixtral_serve,mixtral_train
    python3 chip_smoke.py --phases build,serve,train,time \
        --against parent=build/parent/flash_attention.cu

Phases (any failure exits non-zero before the last line):
  build       build the CUDA kernels from src/repro_torch/kernels/csrc/;
              the flash forward and backward (bf16, and f32 on three bf16
              pieces), the bf16 SSD body's product passes, the SSD
              backward's product passes (bf16, and f32 on pieces) and the
              bf16 paged body, at every head dim they take (head dim 80
              among them), must run on wgmma and TMA alone (SASS: HGMMA
              and UTMALDG, no HMMA; no ptxas C7520), and the flash and SSD
              backwards' wgmma bodies with a stack frame of 0 bytes
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
  gemma2_path gemma2-27b at full width, 2 layers (local with its window
              cut to 512, global), f32, weights drawn on the card and
              copied to the cpu: as path, prompts of 700 and 37 tokens, 9
              new ones (the long prompt's ring wraps); the attention
              softcap 50 in the flash and paged kernels
  gemma2_serve
              gemma2-27b at full width and depth (46 layers, 54.4 GB of
              bf16 weights on the one card): 8 requests with prompts of
              4200-5200 tokens (past the window of 4096, in the 8192-token
              bucket), 32 new tokens each, 8 slots; 46 flash launches a
              prefill, the paged kernel in the 23 global layers a tick;
              the peak of device memory
  zamba2_serve
              zamba2-2.7b at full width and depth, bf16: 16 requests with
              prompts of 600-4000 tokens, each prefilled at its exact
              length, 32 new tokens each, 8 slots; 9 flash launches (the
              banks' invocations, head dim 80) and 54 ssd_scan a prefill,
              9 paged launches a tick; the peak of device memory
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
              with the script at nice 15 (the cpu sides' process)
  gemma_train_path
              gemma3-4b at full width, 2 layers (local with its window cut
              to 256, global), f32, B 1 x S 396, 2 steps: as
              ssm_train_path (the windowed flash backward at head dim 256)
  gemma2_train_path
              gemma2-27b at full width, 2 layers (local with its window cut
              to 128, global), f32, B 1 x S 320, 2 steps: as
              ssm_train_path (the softcap flash backward); both sides'
              weights drawn on the card (the cpu side's process too)
  train_cli   bert-mlm-120m at full width and depth, f32 (the launcher's
              defaults), batch 32 x 512 from the DataPipeline over a
              1000-function corpus, through repro_torch.launch.train.main:
              (a) 6 steps with the R3 autotune; (b) the same run with
              sharded checkpoints, stopped after the step-3 one; (d) that
              checkpoint resumed through runner.resume and TrainLoop with
              the device prefetch 4 deep, and (c) through a fresh main
              (depth 2), whose losses at steps 4-6 must each equal (a)'s
              bit for bit; launch counts per step as in train, every batch
              placed by the device prefetch, the loss falling; the
              prefetch's batches equal to the host's at depths 2 and 4
  ssm_train   mamba2-130m at full width and depth, B 16 x S 1024 from the
              DataPipeline: (a) 6 steps of repro_torch.launch.train.main
              at its f32 defaults, checkpointed every 3 steps; (b) (a)'s
              step-3 checkpoint resumed, whose losses at steps 4-6
              must equal (a)'s bit for bit; (c)
              6 steps of trainer.train with bf16 parameters and
              activations at microbatch 2, every gradient handed to AdamW
              in f32; the loss falls in each, and every SSD scan and loss
              chunk, forward and backward, goes through the kernels
              (launch counts per step); step time, MFU and device busy
  gemma_train gemma3-4b at full width, depth cut to 6 (5 local, 1 global), B
              4 x S 2048 from the DataPipeline with the launcher's rolled
              labels: (a) 4 steps of trainer.train in f32, (b) 4 in bf16
              at microbatch 2; the loss falls, launches per step exact
              (2L flash forwards, L backwards, 2C and C xent at V 262144),
              step time, MFU and device busy
  gemma2_train
              gemma2-27b at full width, depth 2 (local with window 4096,
              global), S 8192 from the DataPipeline: (a) 4 steps in f32 at
              B 1, (b) 4 in bf16 at B 2 and microbatch 2; as gemma_train
              (the softcap flash backward, V 256000)
  zamba2_train
              zamba2-2.7b at full width and depth (2.445 G parameters), S
              4096 from the DataPipeline: (a) 4 steps in f32 at B 1, (b) 4
              in bf16 at B 4 and microbatch 2; as gemma_train (18 flash
              forwards, 9 backwards, 108 scans and 54 scan backwards a
              step and microbatch)
  zamba2_path zamba2-2.7b at full width, (M, A, M, B), f32, weights drawn
              on the card: as path, prompts of 300 and 37 tokens, 9 new
              ones; the shared invocations through the flash and paged
              kernels at head dim 80, the Mamba2 blocks through ssd_scan
              (its cpu side in the cpu sides' process)
  zamba2_train_path
              zamba2-2.7b at full width, (M, A, M, A) (bank A's gradient
              the sum of two invocations), f32, B 1 x S 512, 2 steps: as
              ssm_train_path
  qwen2_path  qwen2-72b at full width, 2 layers (4.25 G parameters), f32,
              weights drawn on the card: as path, prompts of 300 and 37
              tokens, 9 new ones; GQA rep 8 in the flash and paged
              kernels, the qkv bias under RMSNorm, the untied lm_head (its
              cpu side in the cpu sides' process)
  llama3_train_path
              llama3-8b at full width, 2 layers, f32, B 1 x S 400, 2
              steps: as ssm_train_path (the GQA rep-4 flash backward at
              head dim 128, the untied lm_head's gradient)
  llama3_serve
              llama3-8b at full width and depth, bf16 (16.1 GB of
              weights): 16 requests with prompts of 600-4000 tokens, 32
              new tokens each, 8 slots; 32 flash launches a prefill, 32
              paged a tick; the peak of device memory
  llama3_train
              llama3-8b at full width, depth cut to 4 (1.923 G
              parameters), S 8192 from the DataPipeline: (a) 6 steps in
              f32 at B 1, (b) 6 in bf16 at B 2 and microbatch 2; as
              gemma_train (8 flash forwards, 4 backwards, 18 xent forwards
              and 9 backwards at V 128256 a step and microbatch)
  mixtral_path, phi35_path
              mixtral-8x7b and phi3.5-moe (LayerNorm, 16 experts, vocab
              32064) at full width, 2 MoE layers, f32, weights drawn on
              the card: as path, prompts of 300 and 37 tokens, 9 new
              ones; besides, the same experts on cuda and cpu for every
              token of every layer of every prefill and tick (its cpu
              side in the cpu sides' process)
  mixtral_train_path
              mixtral-8x7b at full width, 1 MoE layer, f32, B 1 x S 256,
              2 steps: as ssm_train_path, and the aux loss of each step
              and the experts of every router call (forward and remat)
  mixtral_serve
              mixtral-8x7b at full width, 24 of its 32 layers, bf16 (70.2
              GB of weights): 8 requests with prompts of 600-4000 tokens,
              32 new tokens each, 8 slots of up to 256 pages; 24 flash
              launches a prefill, 24 paged a tick; one 4096-token
              prefill's experts: k of them a token in every layer
  mixtral_train
              mixtral-8x7b at full width, depth cut to 2 (3.16 G
              parameters), S 4096 from the DataPipeline: (a) 4 steps in
              f32 at B 1, (b) 4 in bf16 at B 2 and microbatch 2; as
              llama3_train, with the aux loss finite in every step and
              f32 gradients into AdamW in (b); MFU on the active
              parameters
  bert350_train
              bert-mlm-350m at full size through
              repro_torch.launch.train.main at its f32 defaults, batch 32 x
              512 from train_cli's DataPipeline data dir, 6 steps: the loss
              falls, launches per step exact; step time and MFU
  bert_max_batch
              R5: the largest batch at S 512 whose trainer.train step
              completes (f32 parameters, bf16 activations, remat), for
              bert-mlm-120m and bert-mlm-350m, in a process of its own:
              the peaks of two small batches give a line, then at most 4
              more steps bracket the limit within 3%; printed beside
              MemoryModel(param_bytes=4, act_factor=150)'s prediction and
              the paper's 184 / 20 on the H100 NVL of 94 GB
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
              rank from the DataPipeline, lr 1e-5, 6 steps: rank 0's losses within
              1e-4 of one process at --batch 32, the ranks' parameters
              equal, launches and 11 all-reduces per rank per step; its
              step-3 checkpoint resumed by 2 ranks, bit for bit; then 6
              steps at the launcher's lr 3e-3 by 2 ranks (spawned by the
              phase), equal bit for bit to one process forming the
              gradient in the ranks' f32 order with no collective (the
              gap to the plain 32-row step recorded); the step's
              all-reduce waits, exposed sync and device busy per rank
  fsdp_path   ddp_path's model and batch with the vocab cut to 32767 (the
              odd vocab leaves the out bias whole: the psum bucket runs):
              2 ranks of ZeRO-3 (scatter_overlap) on the one card over
              gloo, run in phase ddp's profile ranks after their timed
              steps (select both phases; the host is quiet by then), its
              one-process references made beside ddp's runs (c): the
              gathered gradients at 0.05 and 25 MB buckets within 1e-5 of
              each leaf's scale of one process, on the 8-row batch and on
              the ranks' row shards, 5 steps of losses within 1e-5;
              microbatch 2, gathered once and under free_after_use,
              against ddp at microbatch 2 (2 steps); per rank per step
              exactly one all-gather and one reduce-scatter a scatter
              bucket (2 x 2 and 2 under free_after_use) and one
              all-reduce a psum bucket; each rank's parameters, mu and nu
              scatter_bytes / 2 + psum_bytes each, the allocator's
              reading recorded
  fsdp        bert-mlm-120m at full width and depth, f32, run inside phase
              ddp: (a) python -m torch.distributed.run --nproc-per-node 2
              -m repro_torch.launch.train --sharding fsdp with ddp's flags,
              6 steps checkpointed at step 3, beside ddp's run (c); then,
              in ddp's profile ranks after their timed steps, (c), the
              launcher's main resumed in those 2 ranks from (a)'s step-3
              checkpoint:
              grad_sync=scatter_overlap, rank 0's losses within 1e-4 of
              ddp's one process and 1e-5 of ddp's run (a), the ranks'
              losses equal, the sub-shard sidecars' parts tiling every
              leaf once, (c)'s losses and final checkpoints equal (a)'s,
              launches and collectives per rank per step exact; (c)'s
              step p50 and tokens/s beside ddp's, each rank's state bytes
              and peak memory beside ddp's run (a)
  time        each kernel at its path's shapes against its plain version,
              its bound and a PyTorch call computing the same function
              (SDPA and its backward op, F.cross_entropy; none computes
              SSD or its backward) as a yardstick: device time per call
              (CUDA-graph replay) and time per back-to-back call; gemma3's
              head-dim-256 flash forward and backward (window 1024 and
              none) and paged decode at its serve and train shapes;
              gemma2's softcap backward at B 1 x S 8192 (window 4096 and
              none, bf16 and f32) beside the same body without the cap,
              its prefill's flash forward and its decode's paged kernel;
              zamba2's head-dim-80 flash forward and backward at B 1 x S
              4096 (bf16 and f32), its 4000-token prefill and its paged
              decode at 8 slots of about 2000 tokens, beside SDPA;
              llama3-8b's flash forward and backward at B 1 x S 8192 (32
              / 8 heads, bf16 and f32) and the paged decode at 8 slots of
              about 2000 tokens at rep 4 (llama3) and rep 8 (qwen2-72b),
              beside SDPA with enable_gqa

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
import contextlib
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
# (started at the lowest CPU priority once the build phase is done) and
# the build gate's SASS reading take the host: nice or not, the builds
# slowed the host-bound serve phases 2-3x where they overlapped them (and
# the build from about 60 s to 193 s when started beside it), and no check
# records a time.  They also run before train_cli: launch.train.main
# leaves the process one intra-op thread (its bit-exact resume needs it),
# which slows a CPU reference run in this process 3.5x.  faults runs late,
# once its builds are done.  The checks whose cpu sides run in the cpu
# sides' process (CPU_REF_KEYS) each come after that side's turn.  That
# process runs for 520 s beside the phases on a slow host: the
# device-bound training phases and train_cli, bert350_train and ssm_train
# run while it does, and the host-bound serve phases after it (beside it
# serve's tick p50 read twice as long, and the serve phases that
# overlapped the llama3 and qwen2 sides took 19-33 s against 12-23 s
# without them, PERF.md §6).  The zamba2, qwen2, llama3 and MoE checks,
# whose sides come last in that process, run after ddp.
PHASES = ("build", "kernels", "path", "gemma_path", "ssm_path", "train_path", "ssm_train_path",
          "gemma_train_path", "gemma2_path", "ddp_path", "train", "gemma_train", "gemma2_train",
          "zamba2_train", "llama3_train", "mixtral_train", "deepseek_train", "gemma2_train_path",
          "train_cli", "bert350_train", "ssm_train", "serve", "gemma_serve", "gemma2_serve",
          "zamba2_serve", "llama3_serve", "mixtral_serve", "deepseek_serve", "ssm_serve", "ddp",
          "fsdp_path", "fsdp",
          "zamba2_path", "zamba2_train_path", "qwen2_path", "llama3_train_path", "mixtral_path",
          "phi35_path", "mixtral_train_path", "deepseek_path", "deepseek_train_path",
          "bert_max_batch", "faults", "time")
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
# against the autograd of the plain ssd_ref on the inputs' values in f64
# (``ssd_bwd_reading``): |err| <=
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
# gemma2-27b's (arXiv:2408.00118): 32 q / 16 kv heads of 128, a window of
# 4096 in every other layer, the logit softcap 50 and the query scale
# 144^-0.5; its train shape B 1 x S 8192 (gemma2_train), and a head slice
# of its 8192-token prefill bucket (the plain forward at all 32 heads
# would hold 2.1 billion scores)
GEMMA2_WINDOW, GEMMA2_SOFTCAP, GEMMA2_SCALE = 4096, 50.0, 144.0**-0.5
GEMMA2_TRAIN_ATTN = (1, 8192, 32, 16, 128, True)
GEMMA2_PREFILL_SLICE = (1, 8192, 4, 2, 128, True)
# zamba2-2.7b's shared attention (arXiv:2411.15242): MHA, 32 heads of 80,
# causal; its train shape B 1 x S 4096 (zamba2_train), which is also its
# longest prefill's (zamba2_serve's prompts reach 4000 tokens)
ZAMBA2_TRAIN_ATTN = (1, 4096, 32, 32, 80, True)
# llama3-8b's attention (arXiv:2407.21783): 32 q / 8 kv heads of 128
# (rep 4), causal, no softcap; its train shape B 1 x S 8192 (llama3_train),
# and a head slice of it for the gate (the time phase gates and times
# all 32 heads).  qwen2-72b's (arXiv:2407.10671): 64 q / 8 kv heads of 128
# (rep 8), at qwen2_path's 300-token prompt, ragged against every tile
LLAMA3_TRAIN_ATTN = (1, 8192, 32, 8, 128, True)
LLAMA3_TRAIN_SLICE = (1, 8192, 8, 2, 128, True)
QWEN2_PROMPT_ATTN = (1, 300, 64, 8, 128, True)
# deepseek-v2-lite's MLA attention at its train shape (B 1 x S 4096, 16 /
# 16 heads): q and k at head dim 192 (128 nope + 64 rope), v at 128
DEEPSEEK_TRAIN_ATTN = (1, 4096, 16, 16, 192, True)


def v_dim(D):
    """v's head dim for q/k head dim D (``hopper::v_dim``): MLA's 192
    takes v at 128, every other head dim its own."""
    return 128 if D == 192 else D

FLASH_CASES = [  # (B, S, H, Hkv, D, causal, window, softcap[, scale])
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
    # gemma2-27b's prefill at its 8192-token bucket (a head slice, rep 2):
    # a local layer (window 4096) and a global one, softcap 50
    GEMMA2_PREFILL_SLICE + (GEMMA2_WINDOW, GEMMA2_SOFTCAP, GEMMA2_SCALE),
    GEMMA2_PREFILL_SLICE + (None, GEMMA2_SOFTCAP, GEMMA2_SCALE),
    # head dim 80 (zamba2-2.7b's MHA; laid out as 128, columns 80-127
    # loaded as zeros): its train shape, which holds its prefills too; the
    # tiles' edges (bf16: 128 q rows a block, 128-key tiles; f32: 32-key
    # tiles), S 1, GQA, and the window and softcap the body also takes
    ZAMBA2_TRAIN_ATTN + (None, 0.0),
    (2, 256, 4, 4, 80, True, None, 0.0),
    (1, 300, 8, 2, 80, False, None, 0.0),      # non-causal, rep 4, ragged
    (2, 1, 4, 4, 80, True, None, 0.0),         # S = 1
    (1, 1, 8, 8, 80, False, None, 0.0),
    (2, 127, 4, 2, 80, True, None, 0.0),       # a key short of a tile
    (1, 129, 4, 4, 80, False, 40, 20.0),       # a key past a tile; window + softcap
    # GQA at rep 4 and 8, head dim 128, no softcap: llama3-8b's train shape
    # (a head slice), qwen2-72b's prompt
    LLAMA3_TRAIN_SLICE + (None, 0.0), QWEN2_PROMPT_ATTN + (None, 0.0),
    # MLA (q/k 192 laid out as 256, v 128; causal): deepseek-v2-lite's train
    # shape, ragged prefills of 300 and 4000, and the D-256 tiles' edges
    # (bf16: 128 q rows a block, 64-key tiles; f32: 64 rows, 16-key tiles)
    DEEPSEEK_TRAIN_ATTN + (None, 0.0), (1, 300, 16, 16, 192, True, None, 0.0),
    (1, 4000, 16, 16, 192, True, None, 0.0), (2, 1, 4, 4, 192, True, None, 0.0),
    (2, 129, 4, 2, 192, True, None, 0.0), (1, 65, 4, 4, 192, True, 40, 0.0),
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
    # gemma2-27b's global layers (rep 2, D 128, softcap 50): 8 slots of
    # about 5000 tokens, page 16, tables of 336 pages
    (8, 32, 16, 128, 16, 2689, 336, None, GEMMA2_SOFTCAP, (4200, 5232)),
    # head dim 80 (zamba2-2.7b's 9 shared invocations a tick, rep 1): 8
    # slots of about 2000 tokens, page 16; rep 2, pages of 8, 32 and 64
    # (a window, a softcap); f32 runs the CUDA-core body (20 lanes of 4)
    (8, 32, 32, 80, 16, 1100, 136, None, 0.0, (1800, 2100)),
    (6, 4, 2, 80, 16, 80, 16, None, 0.0, (0, 255)),
    (4, 8, 8, 80, 8, 64, 12, 40, 0.0, (0, 95)),
    (6, 4, 4, 80, 32, 80, 16, None, 0.0, (63, 511)),
    (6, 4, 4, 80, 64, 40, 8, None, 30.0, (0, 511)),
    # llama3-8b's decode (rep 4, D 128): 8 slots of 600-4000 tokens, page
    # 16, as llama3_serve; qwen2-72b's (rep 8), as qwen2_path's
    (8, 32, 8, 128, 16, 1600, 256, None, 0.0, (600, 4000)),
    (8, 64, 8, 128, 16, 200, 24, None, 0.0, (0, 340)),
]


# bert-mlm-120m's attention at the train phases' batch 32 x 512: the shape
# the train and train_cli phases give the flash forward and backward
BERT_ATTN = (32, 512, 12, 12, 64, False)
# phase time's windowed flash backward below D 256, {head dim: window}:
# bert's shape made causal at D 64, starcoder2-3b's GQA shape at D 128
WINDOW_TIMED = {64: 128, 128: 200}

# the backward kernel: (B, S, H, Hkv, D, causal[, window[, softcap, amp]]);
# a softcap case takes gemma2's query scale and q drawn times amp
# (``bwd_case_opts``), so that the scores reach the cap
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
    # the softcap (D 128, causal, rep 2): the tiles' edges (bf16 64-row
    # tiles and 128 rows or keys a block; f32 32-row and 32-key tiles) and
    # ragged S at cap 5 with q times 4 (|t| up to 0.998), windows across
    # the 128-key tiles, cap 1 with q times 4 (half the scores at |t| >
    # 0.99, where 1 - t^2 cancels), and gemma2's heads at S 4352, past its
    # window of 4096 by two tiles, windowed and global
    *[(2, S, 4, 2, 128, True, None, 5.0, 4.0) for S in (31, 63, 65, 129, 300)],
    (1, 700, 8, 4, 128, True, 200, 5.0, 4.0), (2, 333, 4, 2, 128, True, 65, GEMMA2_SOFTCAP, 1.0),
    (1, 257, 4, 2, 128, True, 50, 1.0, 4.0),
    (1, 4352, 32, 16, 128, True, GEMMA2_WINDOW, GEMMA2_SOFTCAP, 1.0),
    (1, 4352, 32, 16, 128, True, None, GEMMA2_SOFTCAP, 1.0),
    # head dim 80 (zamba2-2.7b: MHA, causal; D 128's tiles): its train
    # shape, S ragged against the 64-row tiles and the 128-row blocks
    # (bf16) and the 32-row tiles (f32), causal and not, S 1, GQA
    ZAMBA2_TRAIN_ATTN,
    (2, 130, 4, 4, 80, True), (2, 300, 8, 2, 80, False), (2, 77, 4, 4, 80, False),
    (1, 1, 4, 4, 80, True), (1, 33, 2, 2, 80, True),
    # GQA at rep 4 and 8, head dim 128, causal, no softcap: llama3-8b's
    # train shape (a head slice), qwen2-72b's prompt
    LLAMA3_TRAIN_SLICE, QWEN2_PROMPT_ATTN,
    # MLA (q/k 192, v 128; causal; D 256's shapes): deepseek-v2-lite's
    # train shape, ragged prefills of 300 and 4000, and the tiles' edges
    # (bf16 32-key and 32-row tiles, f32 16-row tiles), GQA, a window
    DEEPSEEK_TRAIN_ATTN, (1, 300, 16, 16, 192, True), (1, 4000, 16, 16, 192, True),
    (2, 33, 4, 4, 192, True), (1, 130, 4, 2, 192, True), (1, 97, 4, 4, 192, True, 40),
]


def bwd_case_opts(case):
    """(window, softcap, amp, scale) of a FLASH_BWD_CASES entry."""
    opt = case[6:]
    window = opt[0] if opt else None
    cap, amp = (opt[1], opt[2]) if len(opt) > 1 else (0.0, 1.0)
    return window, cap, amp, GEMMA2_SCALE if cap else None

XENT_CASES = [  # (T, V)
    (3904, 32768),   # one loss chunk of the train phase: 32 x 122 rows
    (37, 1000),      # a ragged last tile
    (5, 1001),       # V odd: the scalar loads
    (300, 4099),     # one column past a tile
    (64, 50),        # less than one tile
    (998, 128256),   # one loss chunk of llama3_train: 998 rows at llama3-8b's vocab
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


def with_slack(torch, x):
    """``x`` copied to the front of a buffer 1 KB longer than itself: the
    planted fault that reads each head's row a box past the head dim (the
    flash backward's maps at an inner extent of 128 at D 80) reads up to
    96 bytes past the tensor's last row, which then stays inside the
    buffer."""
    buf = torch.empty(x.numel() + 1024 // x.element_size(), dtype=x.dtype, device=x.device)
    return buf[:x.numel()].view(x.shape).copy_(x)


def _flash_inputs(torch, case, dtype, gen, amp=1.0):
    B, S, H, Hkv, D, *_ = case
    mk = lambda *s: with_slack(torch, torch.randn(*s, generator=gen, device="cuda").to(dtype))
    q = mk(B, S, H, D) if amp == 1.0 else with_slack(
        torch, (torch.randn(B, S, H, D, generator=gen, device="cuda") * amp).to(dtype))
    return q, mk(B, S, Hkv, D), mk(B, S, Hkv, v_dim(D))


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


def flash_reading(torch, q, k, v, causal, window=None, softcap=0.0, scale=None):
    """The forward kernel against the plain version, a group of kv heads
    at a time (``head_groups``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    got = flash_attention_fwd(q, k, v, **opts)
    B, S, H, _ = q.shape
    Hkv = k.shape[2]
    rep_ = H // Hkv
    readings = []
    for g0, g1 in head_groups(B, S, Hkv, rep_):
        qh = q[:, :, g0 * rep_:g1 * rep_].float()
        kh, vh = k[:, :, g0:g1].float(), v[:, :, g0:g1].float()
        want = ref.flash_attention_ref(qh, kh, vh, **opts)
        want_abs = ref.flash_attention_ref(qh, kh, vh.abs(), **opts)
        readings.append(gate(torch, got[:, :, g0 * rep_:g1 * rep_], want, want_abs,
                             str(got.dtype).split(".")[1]))
    return max(readings, key=lambda r: r[1])


def paged_reading(torch, q, kp, vp, tables, pos, window=None, softcap=0.0, scale=None):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_fwd

    opts = dict(window=window, softcap=softcap, scale=scale)
    got = paged_attention_fwd(q, kp, vp, tables, pos, **opts)
    q, kp, vp = q.float(), kp.float(), vp.float()
    want = ref.paged_attention_ref(q, kp, vp, tables, pos, **opts)
    want_abs = ref.paged_attention_ref(q, kp, vp.abs(), tables, pos, **opts)
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


def _attention_grads64(torch, q, k, v, do, causal, window, softcap=0.0, scale=None):
    """dq, dk, dv of the plain version's function (softmax attention,
    masked, scale D^-1/2 unless given, the scores capped at c tanh(s / c)
    with a softcap c) computed in f64 throughout, on the f32 inputs: the
    f32 backward gate's reference.  The plain version itself takes its
    scores in f32, and at head dim 256 and S 2048 its own f32 rounding
    exceeds the 2e-5 bar (phase time records it beside the kernel's as
    ``plain_f32_err_vs_f64``; PERF.md §6); against this reference the
    gate reads the kernel's error alone."""
    xs = [x.detach().double().requires_grad_(True) for x in (q, k, v)]
    S, rep = q.shape[1], q.shape[2] // k.shape[2]
    with torch.enable_grad():
        kr, vr = (x.repeat_interleave(rep, 2) for x in xs[1:])
        s = torch.einsum("bqhd,bkhd->bhqk", xs[0], kr) * (scale or q.shape[3]**-0.5)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        hide = hidden_mask(torch, S, causal, window, q.device)
        p = torch.softmax(s.masked_fill(hide, -math.inf), -1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    return torch.autograd.grad(out, xs, do.double())


def head_groups(B, S, Hkv, rep, budget=2**27):
    """[(kv head lo, hi)]: the kv heads of a plain reading a group at a
    time, so that a group's (B, heads, S, S) scores stay under ``budget``
    elements (gemma2's 32 heads at S 8192 hold 2.1 billion scores; every
    other case is one group)."""
    n = max(1, min(Hkv, budget // max(1, B * rep * S * S)))
    return [(g, min(g + n, Hkv)) for g in range(0, Hkv, n)]


def flash_bwd_reading(torch, q, k, v, do, causal, window=None, softcap=0.0, scale=None):
    """The backward kernel (fed the forward kernel's o and lse) against
    the autograd of the plain version on the f32 inputs (f32 kernels: the
    same function in f64, ``_attention_grads64``), a group of kv heads at
    a time (``head_groups``: each group's gradients are its own).  bf16
    limit per element: u (|want| + want_abs) + 1e-5 with u = 2^-8.  The
    kernel recomputes S and dP exactly (bf16 products, f32 sums) and P in
    f32 from the forward's f32 lse; the bf16 roundings it makes are
      - its outputs: u |want|;
      - P and dS as operands of dV = P^T dO, dK = dS^T q, dQ = dS K:
        u P^T |dO|, u scale |dS|^T |q|, u scale |dS| |K|;
      - the forward's output O inside Delta = rowsum(dO O): with the
        forward's gate |O~ - O| <= u (|O| + P|V|), Delta is off by at
        most u Dabs, Dabs = rowsum(|dO| (|O| + P|V|)), so dS by u P Dabs,
        which adds u scale (P Dabs) |K| to dq and u scale (P Dabs)^T |q|
        to dk.
    With a softcap c, dS = P (dP - Delta) (1 - t^2), t = tanh(s scale /
    c): dS and its Delta term carry the factor 1 - t^2.  want_abs sums
    those terms for each output (over the rep query heads of a kv head for
    dk and dv)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    o, lse = flash_attention_fwd(q, k, v, return_lse=True, **opts)
    got = flash_attention_bwd(q, k, v, with_slack(torch, o), lse, do, **opts)
    del o, lse
    dname = str(q.dtype).split(".")[1]
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep_ = H // Hkv
    scale_ = scale or D**-0.5
    readings = []
    for g0, g1 in head_groups(B, S, Hkv, rep_):
        qh, doh = (x[:, :, g0 * rep_:g1 * rep_] for x in (q, do))
        kh, vh = (x[:, :, g0:g1] for x in (k, v))
        parts = (got[0][:, :, g0 * rep_:g1 * rep_], got[1][:, :, g0:g1], got[2][:, :, g0:g1])
        if dname == "float32":
            want = _attention_grads64(torch, qh, kh, vh, doh, causal, window, softcap, scale)
            readings += [gate(torch, g, w, None, dname) for g, w in zip(parts, want)]
            continue
        fn = lambda q_, k_, v_: ref.flash_attention_ref(q_, k_, v_, **opts)
        _, want = _plain_grads(torch, fn, (qh, kh, vh), doh)
        hkv = g1 - g0
        qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (qh, kh, vh, doh))   # (B,h,S,D)
        kf, vf = (x.repeat_interleave(rep_, dim=1) for x in (kf, vf))
        s = (qf @ kf.transpose(-1, -2)) * scale_
        cap = 1.0
        if softcap:
            t = torch.tanh(s / softcap)
            s, cap = t * softcap, 1 - t * t                       # cap: the derivative
            del t
        hide = hidden_mask(torch, S, causal, window, q.device)
        s = s.masked_fill(hide, ref.NEG_INF)
        del hide
        p = torch.softmax(s, dim=-1)                              # (B,h,S,S)
        del s
        o = p @ vf
        dabs = (dof.abs() * (o.abs() + p @ vf.abs())).sum(-1, keepdim=True)   # (B,h,S,1)
        ds = p * (dof @ vf.transpose(-1, -2) - (dof * o).sum(-1, keepdim=True))
        w = (p * dabs + ds.abs()) * cap
        del ds, cap
        dq_abs = (w @ kf.abs()) * scale_
        kv_sum = lambda x: x.unflatten(1, (hkv, rep_)).sum(2).transpose(1, 2)
        dk_abs = kv_sum((w.transpose(-1, -2) @ qf.abs()) * scale_)
        dv_abs = kv_sum(p.transpose(-1, -2) @ dof.abs())
        del w, p
        abs_terms = (dq_abs.transpose(1, 2), dk_abs, dv_abs)
        readings += [gate(torch, g, w_, a, dname) for g, w_, a in zip(parts, want, abs_terms)]
    return max(readings, key=lambda r: r[1])


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
    plain ssd_ref on the inputs' values in f64 (see SSD_BWD_REL); the
    worst.  dA sums terms over every step that can cancel, and the plain
    f32 version is then off by a share of the gate on its own (0.70 of it
    on the card at one SSD_BWD_CASES draw): against f64 the gate reads the
    kernel's error alone, as the f32 flash backward's does."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    got = ssd_scan_bwd(x, dt, A, Bm, Cm, gy, gstate, chunk)
    xs = [t.detach().double().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    with torch.enable_grad():
        outs = ref.ssd_ref(*xs, chunk)
    want = torch.autograd.grad(outs, xs, (gy.double(), gstate.double()))
    u = BF16_U if x.dtype == torch.bfloat16 else 0.0
    out = []
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        err = (g.double() - w).abs()
        lim = (u if name in ("dx", "dB", "dC") else 0.0) * w.abs() \
            + SSD_BWD_REL * w.abs().max() + SSD_BWD_ATOL
        out.append((err.max().item(), (err / lim).max().item()))
    return max(out, key=lambda r: r[1])


def kernel_readings(torch, dname, only=None):
    """(kernel, case, max abs error, error / limit) for every case, on
    inputs drawn from one seed, each as it is read; ``only``: the kernels
    to read."""
    dtype = getattr(torch, dname)
    want = lambda *names: only is None or any(n in only for n in names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if want("flash_attention"):
        for case in FLASH_CASES:
            causal, window, cap, *scale = case[5:]
            yield ("flash_attention", case, *flash_reading(
                torch, *_flash_inputs(torch, case, dtype, gen), causal, window, cap,
                *scale))
    if want("paged_attention"):
        for case in PAGED_CASES:
            window, cap = case[7:9]
            yield ("paged_attention", case, *paged_reading(
                torch, *_paged_inputs(torch, case, dtype, gen), window, cap))
    if want("flash_attention_bwd"):
        for case in FLASH_BWD_CASES:
            B, S, H, Hkv, D, causal = case[:6]
            window, cap, amp, scale = bwd_case_opts(case)
            q, k, v = _flash_inputs(torch, (B, S, H, Hkv, D), dtype, gen, amp)
            do = with_slack(torch, torch.randn(B, S, H, v_dim(D), generator=gen,
                                               device="cuda").to(dtype))
            if case == BERT_ATTN and want("flash_attention"):    # its forward too
                yield ("flash_attention", case, *flash_reading(torch, q, k, v, causal))
            yield ("flash_attention_bwd", case, *flash_bwd_reading(
                torch, q, k, v, do, causal, window, cap, scale))
            del q, k, v, do
    if want("fused_xent", "fused_xent_bwd"):
        for case in XENT_CASES:
            fwd, bwd = xent_readings(torch, *_xent_inputs(torch, case, dtype, gen))
            yield ("fused_xent", case, *fwd)
            yield ("fused_xent_bwd", case, *bwd)
    if want("ssd_scan"):
        for case in SSD_CASES:
            yield ("ssd_scan", case, *ssd_reading(
                torch, *_ssd_inputs(torch, case, dtype, gen), case[6]))
    if want("ssd_scan_bwd"):
        for case in SSD_BWD_CASES:
            yield ("ssd_scan_bwd", case, *ssd_bwd_reading(
                torch, *_ssd_bwd_inputs(torch, case, dtype, gen), case[6]))


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
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "dq with a softcap: dS without the cap's derivative 1 - t^2",
     "s[x] = hopper::exp2_approx(fmaf(th, post, -lse2[r])) * fmaf(-th, th, 1.f);  // dq: P (1 - t^2)",
     "s[x] = hopper::exp2_approx(fmaf(th, post, -lse2[r]));  // dq: P (1 - t^2)", "bfloat16"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "D 80: the inputs' maps' inner extent is 128 (whole boxes), so a box reads the next "
     "head's columns 80-127 in place of zeros (into Delta = rowsum(dO O))",
     "constexpr int MAP_COLS = D;  // the inner extent of the q, k, v, o and dO maps",
     "constexpr int MAP_COLS = DqSmem<D, NP>::NB * BOX;  // the inner extent of the q, k, v, "
     "o and dO maps", "bfloat16"),
    ("flash_attention", ("flash_attention",),
     "MLA (D 192, v 128): S = Q K^T stops at column 128 (q_rope . k_rope dropped)",
     "for (int kk = 0; kk < D / 16; ++kk)",
     "for (int kk = 0; kk < (D == 192 ? 8 : D / 16); ++kk)", "bfloat16"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "MLA (D 192, v 128): dK's columns 128-191 stored as zeros",
     "acc_to_boxes<NH == 1 ? D : DH>(sm + L::K + wg * NB * BOX_BYTES, dk, p.scale, rl0, g, t);",
     "acc_to_boxes<NH == 1 ? D : DH>(sm + L::K + wg * NB * BOX_BYTES, dk, "
     "D == 192 && part == 1 ? 0.f : p.scale, rl0, g, t);", "bfloat16"),
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


def _start_nvcc(src, lib, nice=False, log_to=None):
    """nvcc for ``src`` into ``lib``; ``nice``: at the lowest CPU priority;
    its output to the file ``log_to``, else a pipe."""
    from repro_torch.kernels import _build

    out = open(log_to, "w") if log_to else subprocess.PIPE
    try:
        return subprocess.Popen((["nice", "-n", "19"] if nice else []) +
                                _build.nvcc_command(src, lib), stdout=out,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)   # a group of its own: stop_children
    finally:
        if log_to:
            out.close()


# nvcc processes of the planted faults at a time: each build of a flash
# source holds a GB or two, and all of them at once beside the cpu sides'
# process met the card machine's 96 GiB
FAULT_BUILDS_AT_ONCE = 8


def start_fault_builds():
    """Write the faulty sources under build/kernels/faults/ and start nvcc
    for the first FAULT_BUILDS_AT_ONCE of them, at the lowest CPU priority
    (the phases before phase faults keep the cores they need; call it once
    the build phase is done, which these builds would slow);
    ``pump_fault_builds`` starts the others as these end, between the
    phases.  Returns {index in FAULTS: [process or None, library path,
    source]}; each build's output goes to a log beside its library."""
    from repro_torch.kernels import _build

    d = _build.BUILD_DIR / "faults"
    d.mkdir(parents=True, exist_ok=True)
    builds = {}
    for i, (name, _, _, old, new, _) in enumerate(FAULTS):
        text = (_build.CSRC / f"{name}.cu").read_text()
        if text.count(old) != 1:
            fail(f"faults: {name}.cu does not hold {old!r} once; update FAULTS")
        src, lib = d / f"{name}-{i}.cu", d / f"lib{name}-{i}.so"
        src.write_text(text.replace(old, new))
        builds[i] = [None, lib, src]
    pump_fault_builds(builds)
    return builds


def pump_fault_builds(builds, at_once=FAULT_BUILDS_AT_ONCE):
    """Start the next of ``builds`` (in FAULTS order) while fewer than
    ``at_once`` run."""
    running = sum(b[0] is not None and b[0].poll() is None for b in builds.values())
    for b in builds.values():
        if running >= at_once:
            break
        if b[0] is None:
            b[0] = _start_nvcc(b[2], b[1], nice=True, log_to=b[1].with_suffix(".log"))
            _children.append(b[0])           # stopped if the script ends first
            running += 1


def check_faults(torch, rec, builds):
    import ctypes
    import os

    from repro_torch.kernels import _build

    res = []
    for i, (name, kernels, bug, _, _, dname) in enumerate(FAULTS):
        pump_fault_builds(builds, at_once=os.cpu_count() or FAULT_BUILDS_AT_ONCE)
        proc, lib, _ = builds[i]
        proc.wait()
        if proc.returncode != 0:
            out = lib.with_suffix(".log").read_text()
            fail(f"faults: the faulty {name} did not build:\n{out}")
        good = _build.swap(name, ctypes.CDLL(str(lib)))
        try:
            readings = [r for r in kernel_readings(torch, dname, only=kernels)
                        if r[0] in kernels]
        finally:
            _build.swap(name, good)
        # a NaN reading (a fault that reads garbage) fails the gate too
        caught = [(case, err, ratio) for _, case, err, ratio in readings
                  if not ratio <= 1.0]
        worst = lambda xs: max(xs, key=lambda x: math.inf if math.isnan(x) else x)
        old, ratio = worst([r[2] for r in readings]), worst([r[3] for r in readings])
        log(f"faults: {name} {dname} with '{bug}': gate fails {len(caught)} of "
            f"{len(readings)} cases {[c[0] for c in caught]}, max error/limit "
            f"{ratio:.2f}; max abs error {old:.3e}"
            + (f" against the former flat {OLD_BF16_TOL}" if dname == "bfloat16" else ""))
        if not caught:
            fail(f"faults: the kernel gate passed {name} with the planted bug '{bug}'")
        finite = lambda x: x if math.isfinite(x) else str(x)   # the record stays JSON
        res.append({"kernel": name, "dtype": dname, "bug": bug, "cases_failed": len(caught),
                    "cases": len(readings), "failed": [list(map(str, c)) for c in caught],
                    "max_ratio": finite(ratio),
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


# the product passes built at head dim 80 (zamba2-2.7b's), each of whose
# instances the build gate must find (``D80_TEMPLATE_ARG`` in its mangled
# name: the first template argument, the head dim, is 80)
D80_FUNCTIONS = (("flash_attention", "flash_fwd_wgmma"),
                 ("flash_attention", "flash_fwd_f32_wgmma"),
                 ("flash_attention_bwd", "dq_wgmma"), ("flash_attention_bwd", "dkdv_wgmma"),
                 ("flash_attention_bwd", "dq_f32_wgmma"),
                 ("flash_attention_bwd", "dkdv_f32_wgmma"), ("paged_attention", "paged_wgmma"))
D80_TEMPLATE_ARG = "ILi80E"
# the same for MLA's q/k head dim 192 (v 128, laid out as 256: the D-256
# bodies' instances at 192)
D192_FUNCTIONS = D80_FUNCTIONS[:-1]
D192_TEMPLATE_ARG = "ILi192E"


# the sources whose wgmma bodies must keep every array in registers: ptxas
# reports a stack frame of 0 bytes for each (the flash backward's dK and dV
# accumulators at head dim 256 are 64 floats each a thread, sized by a
# template; the SSD backward's pair pass holds dB or dC, dx, two tile
# products and the pieces of M or W; the f32 SSD forward's out pass y, a
# partial, S and map(S)'s three pieces; an array moved to local memory
# would show here)
FRAMELESS_SOURCES = ("flash_attention_bwd", "ssd_scan_bwd", "ssd_scan")
# the build gate's SASS reading runs beside the cuda-against-cpu checks
# and is gated before this phase, the first that records a time
SASS_GATED_BY = "ddp_path"


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


def start_sass_reads():
    """``sass_counts`` of every library of ``WGMMA_FUNCTIONS``, each in a
    process of its own (``chip_smoke.py --sass-counts LIB``), all started
    at once: {library: process}.  The reading takes about 30 s on the card
    machine, so it runs beside the first checks (threads of this process
    slowed the kernel gate 2x, their parsing holding the interpreter), and
    ``sass_results`` gates it before the first phase from
    ``SASS_GATED_BY`` on."""
    import os

    from repro_torch.kernels import _build

    procs = {}
    for n in dict(WGMMA_FUNCTIONS):
        procs[n] = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--sass-counts",
             str(_build._lib_path(_build.CSRC / f"{n}.cu"))], cwd=ROOT, stdout=subprocess.PIPE,
            text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            start_new_session=True)
        _children.append(procs[n])
    return procs


def sass_results(procs):
    """{library: ``parse_sass`` counts} from ``start_sass_reads``'s
    processes, once each has ended."""
    out = {}
    for n, p in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            fail(f"the SASS reading of {n} exited {p.returncode}")
        out[n] = json.loads(text)
    return out


def wgmma_build_facts(rec, all_sass):
    """The flash forward and backward (bf16 and f32), the bf16 SSD body,
    the SSD backward's wgmma body and the bf16 paged body as built: ptxas's report (registers, spill bytes)
    and SASS counts (``all_sass``: {library: ``parse_sass`` counts}) of
    every instance of ``WGMMA_FUNCTIONS``.  Fails unless
    each runs on HGMMA and UTMALDG with no HMMA, if one of
    ``D80_FUNCTIONS`` has no head-dim-80 instance or one of
    ``D192_FUNCTIONS`` no head-dim-192 one, if ptxas serialized a
    wgmma (its warning C7520), or if a wgmma body of
    ``FRAMELESS_SOURCES`` has a stack frame."""
    names = list(dict(WGMMA_FUNCTIONS))
    facts, faults = {}, []
    for name in names:
        ptxas = rec["ptxas"].get(name, {})
        sass = all_sass[name]
        for _, part in (f for f in WGMMA_FUNCTIONS if f[0] == name):
            for k, v in sass.items():
                if part in k:
                    log(f"{name} {k}: SASS {v}; ptxas {ptxas.get(k, 'not built in this run')}")
            faults += wgmma_route_faults(sass, part)
        for funcs, arg, D in ((D80_FUNCTIONS, D80_TEMPLATE_ARG, 80),
                              (D192_FUNCTIONS, D192_TEMPLATE_ARG, 192)):
            for _, part in (f for f in funcs if f[0] == name):
                if not any(part in k and arg in k for k in sass):
                    faults.append(f"{name}: no {part} body at head dim {D}")
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


def engine_side(torch, cfg, prompts, max_new, engine_kw, model):
    """The paged engine over ``model`` (f32) serving ``prompts``: every
    prefill's and decode tick's logits (host copies), the greedy tokens,
    the kernel launches and the decode ticks."""
    from repro_torch.configs import default_run_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.serve.engine import PagedServeEngine

    run = default_run_config(cfg, ShapeConfig("serve", 0, 0, "decode"))
    eng = PagedServeEngine(model, run, **engine_kw)
    logs, routes = [], []
    _tap(eng, logs)
    ops.reset_launch_counts()
    with route_tap(torch, routes):
        outs = serve(eng, prompts, max_new=max_new)
    return {"logs": logs, "outs": outs, "launches": dict(ops.launch_counts),
            "decode_ticks": eng.decode_ticks, "routes": routes}


PATH_ENGINE_KW = dict(page=16, n_pages=128, max_slots=4, max_pages=32)


def compare_engines(torch, name, cfg, prompts, max_new, want_launches, engine_kw, cpu):
    """The paged engine on cuda and on cpu (plain versions) from the same
    f32 weights: an MoE model's experts the same for every token of every
    router call (before anything else), each prefill's and decode tick's
    logits within PATH_REL_TOL of the largest cpu logit, the same greedy
    tokens; the
    cuda run's kernel launches must equal ``want_launches(decode ticks)``
    and the cpu run must launch none.  ``engine_kw``: the engines' pool
    sizes.  The weights are drawn from seed 0 on the card (the card draws
    gemma2's 2.3 G in a second, the cpu in about 25); ``cpu``: the cpu
    side's ``engine_side`` on the same weights, copied to the cpu in a
    process of its own (``--cpu-ref``)."""
    from repro_torch.models.model import build_model

    model_gpu = build_model(cfg, seed=0, device="cuda")
    sides = {"cpu": cpu,
             "cuda": engine_side(torch, cfg, prompts, max_new, engine_kw, model_gpu)}
    routing = same_routes(torch, name, cpu["routes"], sides["cuda"]["routes"]) \
        if cfg.moe is not None else {}
    for dev, side in sides.items():
        counts, ticks = side["launches"], side["decode_ticks"]
        log(f"{name} {dev}: launches {counts}, ticks {ticks}")
        if dev == "cuda" and counts != want_launches(ticks):
            fail(f"{name}: the cuda run did not go through the kernels: {counts}, "
                 f"expected {want_launches(ticks)}")
        if dev == "cpu" and counts:
            fail(f"{name}: the cpu run launched kernels: {counts}")
    outs = {dev: side["outs"] for dev, side in sides.items()}
    if outs["cpu"] != outs["cuda"]:
        fail(f"{name}: greedy tokens differ: cpu {outs['cpu']} cuda {outs['cuda']}")
    worst = 0.0
    for (kind, a), (_, b) in zip(sides["cpu"]["logs"], sides["cuda"]["logs"], strict=True):
        rel = ((a - b).abs().max() / a.abs().max()).item()
        worst = max(worst, rel)
        if not torch.isfinite(b).all() or not rel <= PATH_REL_TOL:
            fail(f"{name}: {kind} logits differ, relative error {rel}")
    n_sets = len(sides["cpu"]["logs"])
    log(f"{name}: {n_sets} logit sets agree, max relative error "
        f"{worst:.3e} (tol {PATH_REL_TOL}); tokens equal")
    return {"max_rel_err": worst, "logit_sets": n_sets, "tokens": outs["cuda"],
            "decode_ticks": sides["cuda"]["decode_ticks"], **routing}


def gemma_cfg(n_layers, window=None):
    """gemma3-4b at full width, its depth cut to ``n_layers``: 2, one
    local layer (window 1024, or ``window``) and one global; 6, the first
    pattern group once (5 local, 1 global); 34, the whole model."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, LayerSpec, ScheduleGroup

    cfg = get_config("gemma3-4b")
    if n_layers == cfg.n_layers:
        return cfg
    local, glob = LayerSpec(kind=ATTN, window=window or GEMMA_WINDOW), LayerSpec(kind=ATTN)
    pattern = {2: (local, glob), 6: (local,) * 5 + (glob,)}[n_layers]
    return dataclasses.replace(cfg, schedule=(ScheduleGroup(pattern=pattern, repeats=1),))


def gemma2_cfg(n_layers, window=None):
    """gemma2-27b at full width, its depth cut to ``n_layers`` (2: one
    local layer and one global), the local layers' window cut to
    ``window`` (the cuda-against-cpu checks, whose cpu sides would
    otherwise run 4096-token prompts through 2.3 G parameters); 46, the
    whole model."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, LayerSpec, ScheduleGroup

    cfg = get_config("gemma2-27b")
    if n_layers == cfg.n_layers:
        return cfg
    local = LayerSpec(kind=ATTN, window=window or GEMMA2_WINDOW)
    return dataclasses.replace(cfg, schedule=(
        ScheduleGroup(pattern=(local, LayerSpec(kind=ATTN)), repeats=n_layers // 2),))


GEMMA2_PATH_KW = dict(page=16, n_pages=128, max_slots=4, max_pages=64)


def zamba2_cfg(pattern=None):
    """zamba2-2.7b at full width: the whole model, or its depth cut to one
    group of ``pattern``, a string of M (a Mamba2 block), A and B (an
    invocation of bank A or B)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ScheduleGroup

    cfg = get_config("zamba2-2.7b")
    if pattern is None:
        return cfg
    full = cfg.schedule[0].pattern
    spec = {"M": full[0], "A": full[6], "B": full[13]}
    return dataclasses.replace(cfg, schedule=(
        ScheduleGroup(pattern=tuple(spec[c] for c in pattern), repeats=1),))


def dense_cfg(arch, n_layers=None):
    """llama3-8b or qwen2-72b at full width, the whole model or its depth
    cut to ``n_layers`` (the same layer repeated)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerSpec, uniform_schedule

    cfg = get_config(arch)
    if n_layers is None:
        return cfg
    return dataclasses.replace(cfg, schedule=uniform_schedule(n_layers, LayerSpec()))


def moe_cfg(arch, n_layers=None):
    """mixtral-8x7b or phi3.5-moe at full width, the whole model or its
    depth cut to ``n_layers`` of its own MoE layer (``dense_cfg``'s
    ``LayerSpec()`` would drop ``moe`` and build a dense MLP of width
    d_ff)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import uniform_schedule

    cfg = get_config(arch)
    spec = cfg.schedule[0].pattern[0]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, schedule=uniform_schedule(n_layers, spec))
    if not all(s.moe for g in cfg.schedule for s in g.pattern):
        fail(f"{arch}: a layer of the cut model is not MoE")
    return cfg


def deepseek_cfg(n_layers=None):
    """deepseek-v2-lite-16b at full width, the whole model (27 MLA layers:
    the dense layer 0, 26 MoE) or cut to its dense layer 0 and
    ``n_layers`` - 1 of its MoE layers (``moe_cfg`` refuses a cut with a
    dense layer)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLA

    cfg = get_config("deepseek-v2-lite-16b")
    if n_layers is not None:
        dense, moe = cfg.schedule
        cfg = dataclasses.replace(cfg, schedule=(dense, dataclasses.replace(
            moe, repeats=n_layers - 1)))
    specs = [s for g in cfg.schedule for _ in range(g.repeats) for s in g.pattern]
    if {s.kind for s in specs} != {MLA} or specs[0].moe or not all(s.moe for s in specs[1:]):
        fail(f"{cfg.name}: the cut is not a dense MLA layer 0 and MoE MLA layers")
    return cfg


@contextlib.contextmanager
def route_tap(torch, log_, gaps=True):
    """Every router call of the port's MoE layers (``models.moe.route``)
    while it is open: its expert indices on the host and, with ``gaps``,
    the smallest gap between a token's k-th and (k+1)-th probability (a
    flip of the top k between two devices needs a gap near their error)."""
    from repro_torch.models import moe

    real = moe.route

    def tapped(p, x, cfg, stat_reduce=None):
        w, idx, aux = real(p, x, cfg, stat_reduce=stat_reduce)
        entry = {"idx": idx.cpu()}
        if gaps:
            with torch.no_grad():
                top = torch.softmax(x.float() @ p["router"].float(), -1).topk(
                    cfg.moe.top_k + 1).values
            entry["gap"] = (top[:, -2] - top[:, -1]).min().item()
        log_.append(entry)
        return w, idx, aux

    moe.route = tapped
    try:
        yield log_
    finally:
        moe.route = real


def same_routes(torch, name, cpu, cuda):
    """Fails unless both sides' router calls chose the same experts for
    every token; reports the smallest top-k gap where they did not."""
    if len(cpu) != len(cuda):
        fail(f"{name}: {len(cpu)} router calls on cpu, {len(cuda)} on cuda")
    for i, (a, b) in enumerate(zip(cpu, cuda)):
        if not torch.equal(a["idx"], b["idx"]):
            fail(f"{name}: router call {i} chose other experts on cuda than on cpu for "
                 f"{int((a['idx'] != b['idx']).any(-1).sum())} tokens; smallest top-k gap "
                 f"cpu {a.get('gap')} cuda {b.get('gap')}")
    gap = min((a["gap"] for a in cpu if "gap" in a), default=None)
    log(f"{name}: {len(cpu)} router calls choose the same experts; smallest top-k gap {gap}")
    return {"router_calls": len(cpu), "min_topk_gap": gap}



def engine_path_spec(key):
    """(cfg, prompts, new tokens, engine sizes) of the cuda-against-cpu
    engine check ``key`` whose cpu side runs in the cpu sides' process.
    path: starcoder2-3b at full width, 2 layers, prompts of 300 tokens (20
    pages, three of the paged kernel's 8-page splits) and 37, 9 new
    tokens.  ssm_path: mamba2-130m at full width, 2 layers, prompts of 300
    tokens (a full chunk of 256 carries its state into a ragged one of
    44) and 37, 9 new tokens.  gemma_path: gemma3-4b at full width, 2 layers (local with
    its window of 1024, global), prompts of 1500 tokens (past the window:
    a ragged ring fill under the 2048-token bucket) and 37, 9 new tokens,
    so the long prompt's decode writes over its ring's oldest positions.
    gemma2_path: gemma2-27b at full width, 2 layers (local with its window
    cut to 512, global), prompts of 700 tokens (past the window: a ragged
    ring fill under the 1024-token bucket) and 37, 9 new tokens, so the
    long prompt's decode writes over its ring's oldest positions.
    zamba2_path: zamba2-2.7b at full width, (M, A, M, B): both banks once,
    prompts of 300 tokens (a full chunk of 256 and a ragged one) and 37,
    each prefilled at its exact length, 9 new tokens.  qwen2_path:
    qwen2-72b at full width (64 q / 8 kv heads of 128, qkv bias under
    RMSNorm, the untied lm_head at vocab 152064), 2 layers (4.25 G
    parameters, 17 GB in f32), prompts of 300 tokens (ragged against the
    flash tiles and the pages) and 37, 9 new tokens.  mixtral_path and
    phi35_path: mixtral-8x7b (8 experts, 3.16 G parameters) and
    phi3.5-moe (LayerNorm, 16 experts, vocab 32064, 2.86 G) at full width,
    2 MoE layers, as qwen2_path.  deepseek_path: deepseek-v2-lite-16b at
    full width (MLA: q/k 192 through the flash kernel in prefill, the
    absorbed latent decode in plain PyTorch; 64 experts, top 6, 2 shared),
    its dense layer 0 and one MoE layer (1.085 G parameters), as
    qwen2_path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA, LayerSpec, uniform_schedule
    from repro_torch.launch.serve import random_prompts

    if key == "ssm_path":
        cfg = dataclasses.replace(get_config("mamba2-130m"), schedule=uniform_schedule(
            2, LayerSpec(kind=MAMBA, has_mlp=False)))
        return cfg, random_prompts(2, [300, 37], cfg.vocab_size, seed=1), 9, PATH_ENGINE_KW
    if key == "path":
        cfg = dataclasses.replace(get_config("starcoder2-3b"),
                                  schedule=uniform_schedule(2, LayerSpec()))
        return cfg, random_prompts(2, [300, 37], cfg.vocab_size, seed=1), 9, PATH_ENGINE_KW
    if key == "gemma_path":
        cfg = gemma_cfg(2)
        return cfg, random_prompts(2, [1500, 37], cfg.vocab_size, seed=1), 9, dict(
            page=16, n_pages=256, max_slots=4, max_pages=128)
    if key == "gemma2_path":
        cfg = gemma2_cfg(2, window=512)
        return cfg, random_prompts(2, [700, 37], cfg.vocab_size, seed=1), 9, GEMMA2_PATH_KW
    if key == "qwen2_path":
        cfg = dense_cfg("qwen2-72b", 2)
        return cfg, random_prompts(2, [300, 37], cfg.vocab_size, seed=1), 9, PATH_ENGINE_KW
    if key in ("mixtral_path", "phi35_path"):
        cfg = moe_cfg("mixtral-8x7b" if key == "mixtral_path" else "phi3.5-moe-42b-a6.6b", 2)
        return cfg, random_prompts(2, [300, 37], cfg.vocab_size, seed=1), 9, PATH_ENGINE_KW
    if key == "deepseek_path":
        cfg = deepseek_cfg(2)
        return cfg, random_prompts(2, [300, 37], cfg.vocab_size, seed=1), 9, PATH_ENGINE_KW
    cfg = zamba2_cfg("MAMB")
    return cfg, random_prompts(2, [300, 37], cfg.vocab_size, seed=1), 9, PATH_ENGINE_KW


def engine_path_cpu_side(torch, key):
    """The cpu side of ``engine_path_spec(key)`` (``engine_side`` on the
    weights drawn from seed 0 on the card and copied to the cpu), for a
    ``--cpu-ref`` process."""
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    cfg, prompts, max_new, kw = engine_path_spec(key)
    with card_lock(torch):
        model = build_model(cfg, seed=0, device="cuda").to("cpu")
    side = engine_side(torch, cfg, prompts, max_new, kw, model)
    log(f"{key} cpu: {len(side['logs'])} logit sets, ticks {side['decode_ticks']}, "
        f"{time.perf_counter() - t0:.1f}s")
    return side


def check_engine_path(torch, rec, key, proc):
    """``engine_path_spec(key)``, f32, the weights drawn on the card; the
    cpu side runs in a process of its own from the start (gemma2's 2.3 G
    parameters take minutes of the 8 cores).  Every prefill launches the
    flash kernel in each attention layer (gemma2: softcap 50, the query
    scale 144^-0.5; zamba2: each bank's invocation at head dim 80) and
    ssd_scan in each Mamba2 block, every tick the paged kernel in each
    global attention layer."""
    cfg, prompts, max_new, kw = engine_path_spec(key)
    rec[key] = compare_engines(
        torch, key, cfg, prompts, max_new,
        lambda ticks: serve_launches(cfg, len(prompts), ticks),
        engine_kw=kw, cpu=cpu_side(torch, key, proc))


def run_gemma2_serve(torch, rec):
    """gemma2-27b at full width and depth, bf16 (54.4 GB of weights):
    8 requests with prompts uniform in 4200-5200 tokens (past the window
    of 4096, in the 8192-token bucket), 32 new tokens each, 8 slots of up
    to 328 pages of 16 tokens (2688 pages: 8.1 GB, the 23 windowed
    layers' rings 6.2 GB); the peak of device memory; device busy of an
    8192-token prefill and of a tick."""
    run_serve(torch, rec, arch="gemma2-27b", key="gemma2_serve", lens=(4200, 5200),
              n_pages=2688, max_pages=328, prefill_S=8192, n_req=8, prefill_n=2)


def run_zamba2_serve(torch, rec):
    """zamba2-2.7b at full width and depth, bf16 (4.9 GB of weights): 16
    requests with prompts uniform in 600-4000 tokens, each prefilled at its
    exact length, 32 new tokens each, 8 slots of up to 256 pages of 16
    tokens; a prefill launches the flash kernel 9 times (each bank's
    invocations, head dim 80) and ssd_scan 54, a tick the paged kernel 9
    times; the peak of device memory; device busy of a 4000-token prefill
    and of a tick."""
    run_serve(torch, rec, arch="zamba2-2.7b", key="zamba2_serve", lens=(600, 4000),
              n_pages=2048, max_pages=256, prefill_S=4000, prefill_n=1)


def run_llama3_serve(torch, rec):
    """llama3-8b at full width and depth, bf16 (16.1 GB of weights): 16
    requests with prompts uniform in 600-4000 tokens (in the 1024-4096
    buckets), 32 new tokens each, 8 slots of up to 256 pages of 16
    tokens; a prefill launches the flash kernel 32 times (GQA rep 4), a
    tick the paged kernel 32 times; the peak of device memory; device busy
    of a 4096-token prefill and of a tick."""
    run_serve(torch, rec, arch="llama3-8b", key="llama3_serve", lens=(600, 4000),
              n_pages=2048, max_pages=256, prefill_S=4096, prefill_n=1)


def run_mixtral_serve(torch, rec):
    """mixtral-8x7b at full width, 24 of its 32 layers, bf16 (35.09 G
    parameters, 70.2 GB of weights; the whole model's 93.4 GB do not fit
    the card): 8 requests with prompts uniform in 600-4000 tokens, 32 new
    tokens each, 8 slots of up to 256 pages of 16 tokens (2048 pages:
    3.2 GB); 24 flash launches a prefill and 24 paged a tick; one
    4096-token prefill's per-expert token counts, k a token in every
    layer; the peak of device memory; device busy of a 4096-token prefill
    and of a tick (the router and up to 8 small expert products a layer:
    host-bound)."""
    run_serve(torch, rec, arch="mixtral-8x7b", key="mixtral_serve", lens=(600, 4000),
              n_pages=2048, max_pages=256, prefill_S=4096, n_req=8, prefill_n=1,
              cfg=moe_cfg("mixtral-8x7b", 24))


def run_deepseek_serve(torch, rec):
    """deepseek-v2-lite-16b whole, bf16 (15.71 G parameters, 31.4 GB of
    weights): 4 requests with prompts uniform in 600-4000 tokens, 32 new
    tokens each, 8 slots of up to 256 pages of 16 tokens (2048 pages of
    the 512-wide latent and the 64-wide rope key: 1.0 GB); 27 flash
    launches a prefill (MLA at q/k 192, v 128) and no paged launch a tick
    (MLA decodes over its gathered latent pages in plain PyTorch); one
    4096-token prefill's per-expert token counts, 6 a token in each of
    the 26 MoE layers; the peak of device memory; device busy of a
    4096-token prefill and of a tick (2 profiled ticks).  Cut for the
    script's time from 8 requests and 4 profiled ticks: a tick of this
    model takes 8585 launches, about 0.28 s."""
    run_serve(torch, rec, arch="deepseek-v2-lite-16b", key="deepseek_serve", lens=(600, 4000),
              n_pages=2048, max_pages=256, prefill_S=4096, n_req=4, prefill_n=1,
              cfg=deepseek_cfg(), tick_n=2)


def run_gemma_serve(torch, rec):
    """gemma3-4b at full width and depth, bf16: 16 requests with prompts
    uniform in 600-3000 tokens (most past the window), 32 new tokens each,
    8 slots of up to 192 pages of 16 tokens; device busy of a 2048-token
    prefill and of a tick."""
    run_serve(torch, rec, arch="gemma3-4b", key="gemma_serve", lens=(600, 3000),
              n_pages=2048, max_pages=192, prefill_S=2048)


def layer_counts(cfg):
    """(attention invocations, those that decode through the paged
    kernel, Mamba2 blocks) of ``cfg``'s schedule: an ATTN or MLA layer and
    each invocation of a shared bank (SHARED_ATTN) count once, and each
    runs the flash kernel over a whole sequence.  The paged kernel serves
    the ATTN and SHARED_ATTN ones without a sliding window (a windowed
    layer decodes over its ring, an MLA layer over its latent pages, both
    in plain PyTorch)."""
    from repro_torch.configs.base import ATTN, MAMBA, MLA, SHARED_ATTN

    specs = [s for g in cfg.schedule for _ in range(g.repeats) for s in g.pattern]
    attn = [s for s in specs if s.kind in (ATTN, SHARED_ATTN, MLA)]
    paged = [s for s in attn if s.kind != MLA and s.window is None]
    return len(attn), len(paged), sum(s.kind == MAMBA for s in specs)


def serve_launches(cfg, n_prefills, ticks):
    """The kernel launches of ``n_prefills`` prefills and ``ticks`` decode
    ticks: the flash kernel in every attention layer and ssd_scan in every
    Mamba2 block of a prefill, the paged kernel in every global attention
    layer of a tick (the Mamba2 blocks decode by the plain step)."""
    n_attn, n_global, n_ssm = layer_counts(cfg)
    want = {"flash_attention": n_attn * n_prefills, "ssd_scan": n_ssm * n_prefills,
            "paged_attention": n_global * ticks}
    return {k: v for k, v in want.items() if v}


def run_serve(torch, rec, seed=0, arch="starcoder2-3b", key="serve", lens=(65, 1024),
              n_pages=1024, max_pages=128, prefill_S=1024, n_req=16, prefill_n=3, cfg=None,
              tick_n=4):
    """``arch`` at full width and depth in bf16 (or ``cfg``, a cut of it),
    random weights from ``seed``: ``n_req`` requests, prompts uniform in
    ``lens`` tokens, 32 new tokens each, all submitted at once; 8 slots,
    page 16.  Every layer's prefill must launch its kernel (flash, or
    ssd_scan), and every decode tick the paged kernel once a global
    attention layer.  ``prefill_n``: the prefills of ``prefill_S`` tokens
    the profile reads; an MoE model's experts are counted over one more
    (``moe_prefill_experts``); ``tick_n``: the ticks the decode profile
    reads."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, random_prompts, serve

    cfg = cfg or get_config(arch)
    max_new = 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(cfg, device="cuda", dtype="bfloat16", seed=seed, page=16,
                       n_pages=n_pages, max_slots=8, max_pages=max_pages)
    if cfg.moe is not None:
        rec[f"{key}_prefill_experts"] = moe_prefill_experts(torch, eng, cfg, prefill_S)
    torch.cuda.synchronize()
    built_gib = torch.cuda.memory_allocated() / 2**30
    log(f"{key}: model + pools built in {time.perf_counter() - t0:.1f}s, "
        f"pools {eng.kv.pool_bytes() / 2**20:.0f} MiB, {built_gib:.1f} GiB on the card "
        f"(peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)")
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
    want = serve_launches(cfg, n_req, ticks)
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
           "decode_ticks": ticks, "launches": counts,
           "built_gib": built_gib, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"{key}: {json.dumps({k: v for k, v in res.items() if k != 'prompt_lens'})}")
    rec[key] = res
    rec[f"{key}_prefill_profile"] = profile_prefill(torch, eng, cfg, S=prefill_S, n=prefill_n)
    rec[f"{key}_decode_profile"] = profile_ticks(torch, eng, cfg, res["decode_tick_p50_ms"],
                                                 n_ticks=tick_n)
    del eng
    torch.cuda.empty_cache()


def moe_prefill_experts(torch, eng, cfg, S):
    """One S-token prefill of an MoE model with its router calls tapped:
    each layer must route exactly k tokens a token (its per-expert counts
    sum to k S); the counts of every layer."""
    from repro_torch.launch.serve import random_prompts

    toks = torch.tensor(random_prompts(1, [S], cfg.vocab_size, 13), device="cuda")
    routes = []
    with torch.inference_mode(), route_tap(torch, routes, gaps=False):
        eng._prefill(eng.model, toks, S)
    counts = [torch.bincount(r["idx"].reshape(-1), minlength=cfg.moe.n_experts).tolist()
              for r in routes]
    k = cfg.moe.top_k
    n_moe = sum(g.repeats * sum(int(s.moe) for s in g.pattern) for g in cfg.schedule)
    if len(counts) != n_moe or any(sum(c) != k * S for c in counts):
        fail(f"{cfg.name}: a {S}-token prefill routed {[sum(c) for c in counts]} "
             f"(token, expert) pairs in its {len(counts)} router calls, not {k * S} in each "
             f"of its {n_moe} MoE layers")
    log(f"{cfg.name}: a {S}-token prefill's experts, layer 0 {counts[0]}, "
        f"layer {len(counts) - 1} {counts[-1]}")
    return {"tokens": S, "top_k": k, "per_layer": counts}


def _by_class(kern, n):
    out = {}
    for e in kern:
        c = _kernel_class(e.key)
        out[c] = out.get(c, 0.0) + e.self_device_time_total / n / 1e3
    return out


# The profiles record the device's activity alone: the host's operator
# events of a step of 55 000 launches (zamba2_train (b)) took the profiler
# a minute to read back, and nothing here reads them.
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


TRAIN_PATH = (2, 128, 5)            # train_path's B, S and steps


def train_path_side(torch, dev):
    """One side of ``check_train_path`` on ``dev``: bert-mlm-120m at full
    width, 2 layers, f32, drawn from seed 0 on the card (the same
    parameters on both sides); the loss and every gradient leaf (host
    copies) of one masked batch, then the losses of TRAIN_PATH's steps,
    and the kernel launches."""
    from repro_torch.configs import default_run_config, get_config
    from repro_torch.configs.base import LayerSpec, ShapeConfig, uniform_schedule
    from repro_torch.core.accum import accumulate_grads
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_state, loss_for, make_train_step

    B, S, n_steps = TRAIN_PATH
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("bert-mlm-120m"),
                              schedule=uniform_schedule(2, LayerSpec()))
    run = default_run_config(cfg, ShapeConfig("train_path", S, B, "train"))
    opt = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=n_steps)
    with card_lock(torch, dev == "cpu"):    # the draw's memory back to the card
        model = build_model(cfg, seed=0, device="cuda").to(dev)
    batches = mlm_batches(torch, cfg, n_steps + 1, B, S, seed=1)
    state = init_state(model, run, seed=None)
    on = lambda b: {k: v.to(dev) for k, v in b.items()}
    ops.reset_launch_counts()
    loss, grads, _ = accumulate_grads(lambda p, b: loss_for(model, p, b, run=run),
                                      state["params"], on(batches[0]), 1)
    grads = {k: g.detach().cpu() for k, g in grads.items()}
    step = make_train_step(model, run, opt)
    losses = [step(state, on(b))[1]["loss"].item() for b in batches[1:]]
    out = {"loss": loss.item(), "grads": grads, "losses": losses,
           "launches": dict(ops.launch_counts), "seconds": time.perf_counter() - t0}
    log(f"train_path {dev}: loss {out['loss']:.6f}, steps {losses}, launches "
        f"{out['launches']}, {out['seconds']:.1f}s")
    return out


def check_train_path(torch, rec, proc):
    """``train_path_side`` on cuda and on cpu (the cpu sides' process):
    relative error max |cuda - cpu| / max |cpu| <= PATH_REL_TOL per
    gradient leaf, and per loss; the kernels launched on cuda only."""
    cuda = train_path_side(torch, "cuda")
    cpu = cpu_side(torch, "train_path", proc)
    counts = cuda["launches"]
    n_fb = 1 + TRAIN_PATH[2]
    if cpu["launches"] or counts.get("flash_attention_bwd") != 2 * n_fb \
            or counts.get("fused_xent_bwd") != n_fb:
        fail(f"train_path: cuda launches {counts}, cpu launches {cpu['launches']}")
    rel = lambda a, b: abs(a - b) / abs(b)
    errs = {"loss": rel(cuda["loss"], cpu["loss"]),
            "steps": max(rel(a, b) for a, b in zip(cuda["losses"], cpu["losses"]))}
    gc, gp = cuda["grads"], cpu["grads"]
    leaf = {k: ((gc[k] - gp[k]).abs().max() / gp[k].abs().max()).item()
            for k in gp if k not in ZERO_GRAD}
    for k, ref_leaf in ZERO_GRAD.items():
        scale = gp[ref_leaf].abs().max().item()
        leaf[k] = max(gc[k].abs().max().item(), gp[k].abs().max().item()) / scale
    errs["grad_leaf"] = max(leaf.values())
    worst = max(leaf, key=leaf.get)
    log(f"train_path: relative errors {errs} (tol {PATH_REL_TOL}); worst leaf {worst}")
    if not all(v <= PATH_REL_TOL for v in errs.values()) or sorted(gc) != sorted(gp) \
            or not all(math.isfinite(x) for x in cuda["losses"]):
        fail(f"train_path: cuda and cpu differ: {errs}, worst leaf {worst} {leaf[worst]}")
    rec["train_path"] = {"rel_err": errs, "worst_leaf": worst, "losses_cuda": cuda["losses"],
                         "losses_cpu": cpu["losses"], "launches": counts}


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
    attention layer's (and bank invocation's) flash forward, again under
    remat, and its backward; each Mamba2 block's scan the same; each loss
    chunk's nll forward, again under its checkpoint, and its backward; all
    per microbatch, whose B / micro rows set the chunks."""
    from repro_torch.train.train_step import loss_chunk_len

    n_chunks = -(-S // loss_chunk_len(B // micro, S, cfg.vocab_size, 1))
    n_attn, _, n_ssm = layer_counts(cfg)
    out = {}
    if n_attn:
        out.update(flash_attention=2 * n_attn * micro, flash_attention_bwd=n_attn * micro)
    if n_ssm:
        out.update(ssd_scan=2 * n_ssm * micro, ssd_scan_bwd=n_ssm * micro)
    return {**out, "fused_xent": 2 * n_chunks * micro, "fused_xent_bwd": n_chunks * micro}


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
# the corpus of the next-token training phases' pipelines: 200 functions
# give 7 rows of 8192 tokens, 13 of 4096, 26 of 2048 and 52 of 1024
# (their steps wrap the epoch); 400 took 10-14 s a build on the card
# machine, and the build's time grows with the count
LM_FUNCTIONS = 200


def run_train_cli(torch, rec, B=32, S=512, n_functions=CLI_FUNCTIONS, steps=6):
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


def run_bert350_train(torch, rec, B=32, S=512, n_functions=CLI_FUNCTIONS, steps=6):
    """bert-mlm-350m (the paper's larger model: 24 layers, d 1024, 16
    heads of 64, 337.4 M parameters) at full size through
    repro_torch.launch.train.main at its defaults (f32, --sharding ddp,
    one process), B x S from the DataPipeline over train_cli's data dir
    (the same corpus, sequence length and vocabulary; built here if
    train_cli has not run), 2 loader workers (train_cli runs the R3
    autotune): the loss falls, launches per step exact; step p50,
    tokens/s, MFU and the peak of device memory."""
    from repro_torch.configs import get_config
    from repro_torch.core.scaling import model_flops
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.train.runner import DEFAULT_PEAK_FLOPS

    cfg = get_config("bert-mlm-350m")
    argv = ["--arch", "bert-mlm-350m", "--batch", str(B), "--seq", str(S),
            "--n-functions", str(n_functions), "--data-dir", str(ROOT / "build" / "train_cli" / "data"),
            "--steps", str(steps), "--workers", "2", "--log-every", "1"]
    want = train_launches_per_step(cfg, B, S)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, tlog = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    per_step = {k: counts.get(k, 0) / steps for k in want}
    losses = [m["loss"] for m in tlog.metrics]
    log(f"bert350_train: launches {counts} over {steps} steps, per step {per_step}, "
        f"losses {losses}")
    if per_step != {k: float(v) for k, v in want.items()}:
        fail(f"bert350_train: kernel launches per step {per_step}, expected {want}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"bert350_train: losses {losses}")
    p50 = tlog.telemetry["step_time_p50"]
    tokens = B * S
    res = {"argv": argv, "batch": B, "seq": S, "steps": steps, "wall_s": wall,
           "params": int(model_flops(cfg, 1) / 6), "launches": counts,
           "launches_per_step": per_step, "losses": losses,
           "first_loss": losses[0], "last_loss": losses[-1],
           "step_time_p50_ms": p50 * 1e3, "tokens_per_s": tokens / p50,
           "mfu": model_flops(cfg, tokens) / (p50 * DEFAULT_PEAK_FLOPS),
           "model_flops_per_step": model_flops(cfg, tokens),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "telemetry": tlog.telemetry}
    log("bert350_train: " + json.dumps({k: v for k, v in res.items()
                                        if k not in ("losses", "telemetry", "argv")}))
    rec["bert350_train"] = res
    del state, tlog
    torch.cuda.empty_cache()


# R5, the paper's largest per-device batch at S 512 (its H100 NVL, 94
# GB): 184 for bert-mlm-120m and 20 for bert-mlm-350m.  The search starts
# from the line through the peaks of two small batches, both at or past
# B 488, where the loss chunk reaches its floor of 8 positions
# (``train_step.loss_chunk_len``) and its logits, about 1 MB a row in f32,
# start to grow with B: from B 32 and 64, where the chunk's logits stay
# at 512 MB, the line put bert-mlm-120m's limit at 4400, and every try
# down to 4014 ran out of memory
PAPER_R5 = {"bert-mlm-120m": 184, "bert-mlm-350m": 20}
MAX_BATCH_SMALL = (512, 640)
MAX_BATCH_SEQ = 512
MAX_BATCH_REL = 0.03            # the bracket: oom <= fit (1 + MAX_BATCH_REL)
MAX_BATCH_TRIES = 4             # steps after the two small batches


def find_max_batch(step_peak, small, capacity):
    """R5 measured: the largest batch whose step fits, bracketed within
    ``MAX_BATCH_REL``.

    ``step_peak(B)`` runs one step at batch B and returns its peak of
    device bytes, or raises ``torch.cuda.OutOfMemoryError``.  Both
    ``small`` batches must fit; then at most ``MAX_BATCH_TRIES`` more
    steps, each at a batch between the largest that fit (``fit``) and the
    smallest that did not (``oom``), with r = ``MAX_BATCH_REL``:
      - before any has run out of memory, the line through the peaks of
        the two largest fits, solved for ``capacity`` bytes, gives the
        limit L: the try is L (1 - r/2) while L lies more than r above
        ``fit``, else fit (1 + r), which either runs out of memory (the
        bracket is then made) or moves ``fit`` up;
      - after, oom / (1 + r), which either fits (the bracket is made) or
        moves ``oom`` down.
    Returns ``{"fit", "oom", "tries", "line"}`` (``line``: base and slope
    of the small batches' fit, bytes and bytes a sample) once ``oom <= fit
    (1 + r)``; raises ``RuntimeError`` if a small batch does not fit or
    the tries end first (none running out of memory among them).  Any
    other error of a step propagates."""
    import torch

    rel = MAX_BATCH_REL
    b1, b2 = sorted(small)
    peaks = {}
    for b in (b1, b2):
        try:
            peaks[b] = step_peak(b)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(f"a small batch does not fit: B {b}") from e
    line = _line(b1, peaks[b1], b2, peaks[b2])
    tried = [(b1, peaks[b1]), (b2, peaks[b2])]
    fit, oom = b2, None
    for _ in range(MAX_BATCH_TRIES):
        if oom is None:
            lo, hi = sorted(peaks)[-2:]
            base, slope = _line(lo, peaks[lo], hi, peaks[hi])
            limit = (capacity - base) / slope if slope > 0 else math.inf
            b = math.floor(limit * (1 - rel / 2)) if limit > fit * (1 + rel) \
                else math.floor(fit * (1 + rel))
        else:
            b = math.ceil(oom / (1 + rel))
        b = max(fit + 1, b if oom is None else min(b, oom - 1))
        try:
            peaks[b] = step_peak(b)
            fit = b
            tried.append((b, peaks[b]))
        except torch.cuda.OutOfMemoryError:
            oom = b
            tried.append((b, None))
        if oom is not None and oom <= fit * (1 + rel):
            return {"fit": fit, "oom": oom, "tries": tried, "line": line}
    raise RuntimeError(f"no bracket within {rel:.0%} after {MAX_BATCH_TRIES} tries: {tried}")


def _line(b1, p1, b2, p2):
    """(base, slope) of the line through (b1, p1) and (b2, p2)."""
    slope = (p2 - p1) / (b2 - b1)
    return p1 - slope * b1, slope


def max_batch_worker(torch):
    """The body of a ``--max-batch-worker`` process (a card to itself, so
    that an out-of-memory try cannot fragment another process's
    allocator): for each BERT size, ``find_max_batch`` over
    one trainer.train step at a time (the train phase's settings: f32
    parameters, bf16 activations, remat; BERT masks at S 512), each step's
    peak the allocator's reserved bytes (max_memory_reserved: a try runs
    out of memory when what the allocator holds, its cached blocks with
    it, would pass the memory free when the process started; the peak of
    allocated bytes, also recorded, stayed 5-7 GB below there at the
    limit, and a line through it put the limit 8-10% too high); the
    readings as JSON to build/max_batch.json."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.scaling import H100_NVL, MemoryModel
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import train

    free, total = torch.cuda.mem_get_info()
    card_total = torch.cuda.get_device_properties(0).total_memory
    out = {"gpu": gpu_line(), "free_bytes": free, "total_bytes": total,
           "card_total_bytes": card_total, "seq": MAX_BATCH_SEQ, "archs": {}}
    S = MAX_BATCH_SEQ
    for arch in PAPER_R5:
        cfg = get_config(arch)
        model = build_model(cfg, seed=0, device="cuda")
        opt = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=1)
        seconds, allocated = {}, {}

        def step_peak(B):
            for p in model.parameters():
                p.grad = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = RunConfig(model=cfg, shape=ShapeConfig("max_batch", S, B, "train"),
                            sharding="ddp", param_dtype="float32",
                            activation_dtype="bfloat16")
            batch = mlm_batches(torch, cfg, 1, B, S, seed=B)
            t0 = time.perf_counter()
            try:
                _, tlog = train(model, run, opt, iter(batch), steps=1, log_every=1, seed=0)
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:
                seconds[B] = time.perf_counter() - t0
                log(f"bert_max_batch {arch}: B {B} out of memory after {seconds[B]:.1f}s")
                raise
            seconds[B] = time.perf_counter() - t0
            loss = tlog.metrics[0]["loss"]
            if not math.isfinite(loss):
                raise RuntimeError(f"{arch}: B {B}: loss {loss}")
            peak = torch.cuda.max_memory_reserved()
            allocated[B] = torch.cuda.max_memory_allocated()
            log(f"bert_max_batch {arch}: B {B} fits, peak {peak / 2**30:.2f} GiB reserved, "
                f"{allocated[B] / 2**30:.2f} GiB allocated, loss {loss:.3f}, {seconds[B]:.1f}s")
            return peak

        found = find_max_batch(step_peak, MAX_BATCH_SMALL, capacity=free)
        model_b = MemoryModel(cfg, param_bytes=4, act_factor=150.0)
        out["archs"][arch] = {
            **found, "seconds": seconds, "allocated": allocated, "paper": PAPER_R5[arch],
            "memory_model_card": model_b.max_batch(S, card_total),
            "memory_model_h100_nvl": model_b.max_batch(S, H100_NVL.hbm_bytes)}
        log(f"bert_max_batch {arch}: {json.dumps(out['archs'][arch])}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    path = ROOT / "build" / "max_batch.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))


def run_bert_max_batch(torch, rec, proc=None):
    """R5 on the card: the largest per-device batch at S 512 whose
    trainer.train step completes, for both BERT sizes, in a process of
    its own (``max_batch_worker``), started once this process has given
    its cached blocks back and the cpu sides' process (which draws
    weights on the card) has ended; printed with the bracket, the line of
    the small batches, ``MemoryModel(param_bytes=4, act_factor=150)``'s
    prediction on this card and the H100 NVL, and the paper's 184 / 20."""
    import gc
    import os

    if proc is not None and proc.poll() is None:
        t0 = time.perf_counter()
        proc.wait(600)
        log(f"bert_max_batch: waited {time.perf_counter() - t0:.1f}s for the cpu sides' process")
    gc.collect()
    torch.cuda.empty_cache()
    path = ROOT / "build" / "max_batch.json"
    path.unlink(missing_ok=True)
    p = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--max-batch-worker"],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         start_new_session=True)
    _children.append(p)
    if p.wait(900) != 0 or not path.exists():
        fail(f"bert_max_batch: the search process exited {p.returncode}")
    res = json.loads(path.read_text())
    for arch, r in res["archs"].items():
        fit, oom = r["fit"], r["oom"]
        if not fit < oom <= fit * (1 + MAX_BATCH_REL):
            fail(f"bert_max_batch {arch}: bracket ({fit}, {oom}) not within {MAX_BATCH_REL:.0%}")
        log(f"bert_max_batch {arch} at S {res['seq']} on {res['gpu']}: largest B that "
            f"completed a step {fit}, smallest out of memory {oom}; the small batches' line "
            f"{r['line'][0] / 2**30:.2f} GiB + {r['line'][1] / 2**20:.1f} MiB a sample reserved; "
            f"MemoryModel(param_bytes=4, act_factor=150) {r['memory_model_card']} on this card's "
            f"{res['card_total_bytes'] / 1e9:.1f} GB ({r['memory_model_h100_nvl']} on the H100 "
            f"NVL's 94 GB); the paper {r['paper']} on the H100 NVL of 94 GB")
    rec["bert_max_batch"] = res


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


def lm_path_spec(key):
    """(cfg, launches_per_step, B, S, n_steps) of the next-token check
    ``key``, both models at full width and 2 layers, f32.
    ssm_train_path: mamba2-130m, B 2 x S 600 (a full chunk and a ragged
    one), 3 steps.  gemma_train_path: gemma3-4b (local with its window cut
    from 1024 to 256, global), B 1 x S 396 (past the window and ragged
    against every tile), 2 steps, so that the second step's loss reads
    AdamW's move of q_norm, k_norm, post1 and post2; the kernel gate holds
    the windowed backward at its window of 1024 at B 2 and 4.  Its cpu
    side is nearly all the tied unembedding at vocab 262144: B 1 x S 1100
    took 133 s of the cpu sides' process (PERF.md §6), so S 396 and a window
    to match.  gemma2_train_path: gemma2-27b (local with its window cut to 128,
    global; the kernel gate holds the window of 4096 at S 4352), B 1 x S
    200 (past the window, ragged against every tile), 2 steps, so that
    the second step's loss reads AdamW's move of a gemma2 model: its cpu
    side is the longest (S 320 took 112-143 s of the cpu sides' process
    at 1 step and 256 s at 2), so S 200.
    zamba2_train_path: zamba2-2.7b, (M, A, M, A): bank A's gradient sums
    its two invocations, B 1 x S 512 (two chunks of 256), 2 steps.
    llama3_train_path: llama3-8b (GQA rep 4, the untied lm_head at vocab
    128256; 1.49 G parameters, its cpu side's f32 state 24 GB), B 1 x S
    400 (one loss chunk, ragged against every tile), 2 steps.
    mixtral_train_path: mixtral-8x7b at 1 MoE layer (1.71 G parameters:
    its cpu side's f32 state about 27 GB, beside llama3's 24), B 1 x S
    256, 2 steps; the aux loss and the experts of every router call too.
    deepseek_train_path: deepseek-v2-lite-16b, its dense layer 0 and one MoE
    layer (1.085 G parameters), B 1 x S 256 (past the D-256 tiles' 64-key
    and 32-row edges; cut from 512 for the cpu side's time, about 58 s at
    512 beside the serve phases), 2 steps, as mixtral's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA, LayerSpec, uniform_schedule

    if key == "ssm_train_path":
        cfg = dataclasses.replace(get_config("mamba2-130m"),
                                  schedule=uniform_schedule(2, LayerSpec(kind=MAMBA, has_mlp=False)))
        return cfg, train_launches_per_step, 2, 600, 3
    if key == "gemma2_train_path":
        return gemma2_cfg(2, window=128), train_launches_per_step, 1, 200, 2
    if key == "zamba2_train_path":
        return zamba2_cfg("MAMA"), train_launches_per_step, 1, 512, 2
    if key == "llama3_train_path":
        return dense_cfg("llama3-8b", 2), train_launches_per_step, 1, 400, 2
    if key == "mixtral_train_path":
        return moe_cfg("mixtral-8x7b", 1), train_launches_per_step, 1, 256, 2
    if key == "deepseek_train_path":
        return deepseek_cfg(2), train_launches_per_step, 1, 256, 2
    return gemma_cfg(2, window=256), train_launches_per_step, 1, 396, 2


def lm_train_side(torch, key, dev):
    """One side of ``check_lm_train_path`` on ``dev``: ``n_steps`` train
    steps of the model drawn from seed 0 on the card (both sides: the
    cpu would take about 25 s for gemma2's 2.3 G parameters) on the
    lm_batches of seed 1; the gradients AdamW gets in the first step,
    every step's loss and aux, the experts of each router call of the
    steps (an MoE model's) and the kernel launches.  On cuda first the
    gradients of the first batch twice, which must be equal bit for
    bit."""
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
    with card_lock(torch, dev == "cpu"):    # the draw's memory back to the card
        model = build_model(cfg, seed=0, device="cuda").to(dev)
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

    # the first step's gradients, kept as they are: AdamW reads them
    # without writing, and the step drops them from the parameters
    # (p.grad = None), so no copy is needed (2.3 G floats for gemma2)
    def spy(c, g, opt_state, params):
        if not grads:
            grads.update((k, v.detach()) for k, v in g.items())
        return real(c, g, opt_state, params)

    step = ts.make_train_step(model, run, opt)
    ts.adamw_update = spy
    routes = []
    try:
        with route_tap(torch, routes):
            mets = [step(state, b)[1] for b in batches]
    finally:
        ts.adamw_update = real
    losses = [m["loss"].item() for m in mets]
    out = {"loss": losses[0], "grads": grads, "losses": losses,
           "aux": [m["aux_loss"].item() for m in mets], "routes": routes,
           "launches": dict(ops.launch_counts), "seconds": time.perf_counter() - t0}
    log(f"{key} {dev}: steps {losses}, launches {out['launches']}, {out['seconds']:.1f}s")
    return out


# The phases whose peak on the card leaves no room for a draw of the cpu
# sides' process (up to qwen2_path's 17 GB): they and that process's
# draws take turns through ``card_lock`` (gemma2_train_path's cuda side
# ran out of memory beside qwen2_path's draw)
CARD_LOCK_PHASES = ("gemma2_train", "zamba2_train", "llama3_train", "gemma2_serve",
                    "mixtral_train", "mixtral_serve", "deepseek_train", "deepseek_serve")


@contextlib.contextmanager
def card_lock(torch, held=True):
    """One at a time on the card's memory, between this script's
    processes (a file lock): the cpu sides' process while it draws a
    model on the card and moves it to the cpu, the main process through
    the phases of CARD_LOCK_PHASES and the next-token checks' cuda sides.
    Neither waits for the other while it holds it, and each gives its
    cached blocks back before it lets go."""
    if not held:
        yield
        return
    import fcntl
    import gc

    path = ROOT / "build" / "card.lock"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            gc.collect()
            torch.cuda.empty_cache()


# The cpu sides of gemma2_path and of the next-token checks run in one
# process of their own (``--cpu-ref KEY,...``), started with the script
# at nice 15, one after another in this order, so that their minutes of
# 8-core work overlap the phases before them (the build's and the
# phases' threads come first, the planted faults' builds, nice 19,
# after), and so that one at a time holds the host's memory: gemma2's
# f32 training side alone takes 46 GB of the card machine's 96 GiB.
# gemma_train_path's took 94 s of its phase's 109 in process (PERF.md §6).
CPU_REF_KEYS = ("path", "gemma_path", "ssm_path", "train_path", "ssm_train_path",
                "gemma_train_path", "gemma2_path", "gemma2_train_path", "zamba2_path",
                "zamba2_train_path", "qwen2_path", "llama3_train_path", "mixtral_path",
                "phi35_path", "mixtral_train_path", "deepseek_path", "deepseek_train_path")
ENGINE_PATH_KEYS = ("path", "gemma_path", "ssm_path", "gemma2_path", "zamba2_path",
                    "qwen2_path", "mixtral_path", "phi35_path", "deepseek_path")
_children = []                      # processes the script stops if it ends early


def stop_children():
    """Each child's process group (nvcc's cicc and ptxas with it)."""
    import os
    import signal

    def signal_group(p, sig):
        try:
            os.killpg(p.pid, sig)
        except (ProcessLookupError, PermissionError):   # not a group of its own
            p.send_signal(sig)

    for p in _children:
        if p.poll() is None:
            signal_group(p, signal.SIGTERM)
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                signal_group(p, signal.SIGKILL)


def cpu_ref_file(key):
    return ROOT / "build" / "cpu_ref" / f"{key}.pt"


def start_cpu_refs(phases):
    """The process of the cpu sides of ``phases`` (CPU_REF_KEYS), or None."""
    import os

    keys = [key for key in CPU_REF_KEYS if key in phases]
    if not keys:
        return None
    for key in keys:
        cpu_ref_file(key).parent.mkdir(parents=True, exist_ok=True)
        cpu_ref_file(key).unlink(missing_ok=True)
    with open(cpu_ref_file("cpu_ref").with_suffix(".log"), "w") as f:
        proc = subprocess.Popen(
            ["nice", "-n", "15", sys.executable, str(ROOT / "chip_smoke.py"),
             "--cpu-ref", ",".join(keys)], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, start_new_session=True)
    _children.append(proc)
    return proc


def cpu_ref_worker(torch, keys):
    """The body of a ``--cpu-ref KEY,...`` process: each key's side in
    turn, written whole (a file renamed into place) before the next one
    starts."""
    import gc

    for key in keys.split(","):
        if key in ENGINE_PATH_KEYS:
            side = engine_path_cpu_side(torch, key)
        elif key == "train_path":
            side = train_path_side(torch, "cpu")
        else:
            side = lm_train_side(torch, key, "cpu")
        tmp = cpu_ref_file(key).with_suffix(".tmp")
        torch.save(side, tmp)
        tmp.rename(cpu_ref_file(key))
        del side
        gc.collect()


def cpu_side(torch, key, proc):
    """The cpu side of ``key``, from the process of ``start_cpu_refs``,
    once its file is written (at most 900 s from now)."""
    t0 = time.perf_counter()
    out = cpu_ref_file(key)
    while not out.exists():
        if proc.poll() is not None and not out.exists():
            text = cpu_ref_file("cpu_ref").with_suffix(".log").read_text()
            fail(f"{key}: the cpu sides' process exited {proc.returncode} without it: "
                 f"{text[-3000:]}")
        if time.perf_counter() - t0 > 900:
            fail(f"{key}: the cpu side took more than 900 s more")
        time.sleep(0.2)
    log(f"{key}: waited {time.perf_counter() - t0:.1f}s for the cpu side")
    return torch.load(out, mmap=True)


def check_lm_train_path(torch, rec, key, proc):
    """A next-token model of ``lm_path_spec(key)`` on cuda and on cpu from
    the same parameters and batches (``lm_train_side``): the first step's
    loss and every gradient leaf, and every step's loss, within
    PATH_REL_TOL; on cuda the first batch's gradients twice equal bit for
    bit, and the kernel launches ``launches_per_step(cfg, B, S)`` a
    forward and backward.  An MoE model's steps first choose the same
    experts on both sides in every router call (the forward's and the
    remat recompute's), and every step's aux loss agrees within
    PATH_REL_TOL."""
    cfg, launches_per_step, B, S, n_steps = lm_path_spec(key)
    with card_lock(torch):
        cuda = lm_train_side(torch, key, "cuda")
    cpu = cpu_side(torch, key, proc)
    routing = same_routes(torch, key, cpu["routes"], cuda["routes"]) \
        if cfg.moe is not None else {}
    want = {k: v * (2 + n_steps) for k, v in launches_per_step(cfg, B, S).items()}
    if cpu["launches"] or cuda["launches"] != want:
        fail(f"{key}: cuda launches {cuda['launches']} (expected {want}), "
             f"cpu launches {cpu['launches']}")
    rel = lambda a, b: abs(a - b) / abs(b)
    errs = {"loss": rel(cuda["loss"], cpu["loss"]),
            "steps": max(rel(a, b) for a, b in zip(cuda["losses"], cpu["losses"]))}
    if cfg.moe is not None:
        if not all(a > 0 and math.isfinite(a) for a in cuda["aux"]):
            fail(f"{key}: aux losses {cuda['aux']}")
        errs["aux"] = max(rel(a, b) for a, b in zip(cuda["aux"], cpu["aux"]))
    gc, gp = cuda["grads"], cpu["grads"]      # compared on the card, a leaf at a time
    leaf = {}
    for k in gp:
        want = gp[k].to(gc[k].device)
        leaf[k] = ((gc[k] - want).abs().max() / want.abs().max()).item()
    errs["grad_leaf"] = max(leaf.values())
    worst = max(leaf, key=leaf.get)
    log(f"{key}: relative errors {errs} (tol {PATH_REL_TOL}); worst leaf {worst}")
    if not all(v <= PATH_REL_TOL for v in errs.values()) or sorted(gc) != sorted(gp) \
            or not all(math.isfinite(x) for x in cuda["losses"]):
        fail(f"{key}: cuda and cpu differ: {errs}, worst leaf {worst} {leaf[worst]}")
    rec[key] = {"rel_err": errs, "worst_leaf": worst, "grad_leaf_rel": leaf,
                "losses_cuda": cuda["losses"], "losses_cpu": cpu["losses"],
                "launches": cuda["launches"], "repeat_bit_equal": True,
                "seconds_cuda": cuda["seconds"], "seconds_cpu": cpu["seconds"],
                "aux_cuda": cuda["aux"], **routing}


def run_ssm_train(torch, rec, B=16, S=1024, n_functions=LM_FUNCTIONS, steps=6):
    """mamba2-130m at full width and depth, B x S from one DataPipeline
    data dir (LM_FUNCTIONS: 52 rows of 1024, 3 batches an epoch, which
    the steps wrap):
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

    want = train_launches_per_step(cfg, B, S)
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
                             steps, train_launches_per_step(cfg, B, S, 2))
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


def run_gemma_train(torch, rec, B=4, S=2048, n_functions=LM_FUNCTIONS, steps=4):
    """gemma3-4b at full width, depth cut to 6 (its first pattern group:
    5 local layers with window 1024, then a global one; at full depth the
    f32 parameters, gradients and AdamW state alone take about 62 GB), B x
    S from the DataPipeline with the launcher's rolled next-token labels:
    (a) ``steps`` steps of trainer.train with f32 parameters and
    activations, (b) ``steps`` with bf16 ones at microbatch 2 (gradients
    summed in f32).  The loss falls in each; launches per step exact; step
    p50, tokens/s, MFU (6ND) and where the device time goes."""
    cfg = dataclasses.replace(gemma_cfg(6), max_position=max(S, 2048))
    run_lm_train(torch, rec, "gemma_train", cfg, S, n_functions, steps,
                 (("a", "float32", B, 1), ("b", "bfloat16", B, 2)))


def run_gemma2_train(torch, rec, S=8192, n_functions=LM_FUNCTIONS, steps=4):
    """gemma2-27b at full width, depth cut to 2 (a local layer with its
    window of 4096 and a global one; the whole model's f32 parameters,
    gradients and AdamW state would take about 435 GB), S 8192 from the
    DataPipeline: (a) ``steps`` steps of trainer.train in f32 at B 1 (37
    GB of parameters, gradients and moments), each the next row of the
    pipeline's B-2 batches, (b) ``steps`` in bf16 at B 2 and microbatch 2;
    as gemma_train: the softcap backward at S 8192 past the window, the
    loss at vocab 256000 through the final softcap."""
    run_lm_train(torch, rec, "gemma2_train", gemma2_cfg(2), S, n_functions, steps,
                 (("a", "float32", 1, 1), ("b", "bfloat16", 2, 2)), n_prof=1)


def run_zamba2_train(torch, rec, S=4096, n_functions=LM_FUNCTIONS, steps=4):
    """zamba2-2.7b at full width and depth (2.445 G parameters: f32
    parameters, gradients and AdamW moments take 39 GB), S 4096 from the
    DataPipeline: (a) ``steps`` steps in f32 at B 1, (b) ``steps`` in bf16
    at B 4 and microbatch 2; as gemma_train: per step and microbatch 18
    flash forwards and 9 backwards at head dim 80 (the banks' invocations,
    each bank's gradient their sum), 108 scans and 54 backwards, the loss
    at vocab 32000."""
    run_lm_train(torch, rec, "zamba2_train", zamba2_cfg(), S, n_functions, steps,
                 (("a", "float32", 1, 1), ("b", "bfloat16", 4, 2)), n_prof=1)


def run_llama3_train(torch, rec, S=8192, n_functions=LM_FUNCTIONS, steps=6):
    """llama3-8b at full width, depth cut to 4 (1.923 G parameters: f32
    parameters, gradients and AdamW moments take 31 GB; the whole model's
    about 128 GB, which waits for FSDP, A8), S 8192 from the DataPipeline:
    (a) ``steps`` steps in f32 at B 1, (b) ``steps`` in bf16 at B 2 and
    microbatch 2; as gemma_train: the GQA (rep 4) causal flash backward at
    head dim 128 without a softcap, the untied lm_head at vocab 128256 in
    the loss (9 chunks of 998 positions a row)."""
    run_lm_train(torch, rec, "llama3_train", dense_cfg("llama3-8b", 4), S, n_functions, steps,
                 (("a", "float32", 1, 1), ("b", "bfloat16", 2, 2)), n_prof=1)


def run_mixtral_train(torch, rec, S=4096, n_functions=LM_FUNCTIONS, steps=4):
    """mixtral-8x7b at full width, depth cut to 2 (3.16 G parameters, 1.05
    G active: f32 parameters, gradients and AdamW moments take 50.7 GB;
    the whole model's 747 GB wait for fsdp across cards), S 4096 from the
    DataPipeline: (a) ``steps`` steps in f32 at B 1, (b) ``steps`` in bf16
    at B 2 and microbatch 2; as llama3_train, with the aux loss finite in
    every step, f32 gradients into AdamW in (b) (C12), MFU on the active
    parameters (6 N_active D)."""
    run_lm_train(torch, rec, "mixtral_train", moe_cfg("mixtral-8x7b", 2), S, n_functions, steps,
                 (("a", "float32", 1, 1), ("b", "bfloat16", 2, 2)), n_prof=1)


def run_deepseek_train(torch, rec, S=4096, n_functions=LM_FUNCTIONS // 2, steps=3):
    """deepseek-v2-lite-16b at full width, its dense layer 0 and one MoE
    layer (1.085 G parameters, 583.5 M active: f32 parameters, gradients
    and AdamW moments take 17.4 GB), S 4096 from the DataPipeline: (a)
    ``steps`` steps in f32 at B 1, (b) ``steps`` in bf16 at B 2 and
    microbatch 2; as mixtral_train: the loss falls, the aux loss is finite
    and positive, launches exact (the flash forward and backward in both
    MLA layers at q/k 192, v 128), f32 gradients into AdamW in (b), MFU on
    the active parameters.  Cut for the script's time from 4 steps and a
    corpus of 200 functions (the 3 batches of 2 x 4096 tokens need far
    fewer)."""
    run_lm_train(torch, rec, "deepseek_train", deepseek_cfg(2), S, n_functions, steps,
                 (("a", "float32", 1, 1), ("b", "bfloat16", 2, 2)), n_prof=1)


def run_lm_train(torch, rec, key, cfg, S, n_functions, steps, runs, n_prof=2):
    """``cfg`` trained by trainer.train on the DataPipeline's next-token
    batches of S tokens (the launcher's rolled labels), one run per
    (tag, dtype, B, microbatch) of ``runs``, ``steps`` steps each at lr
    1e-3: the pipeline's batches hold the largest B, and a run of fewer
    rows takes them in order, B rows a step.  The loss falls in each run,
    launches per step exact; step p50, tokens/s, MFU (6ND), the peak of
    device memory and (over ``n_prof`` profiled steps) where the device
    time goes; the gradient dtypes AdamW got.  An MoE model's aux loss is
    finite and positive in every step, and AdamW gets f32 gradients under
    accumulation."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.scaling import model_flops
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.models.model import build_model
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.runner import DEFAULT_PEAK_FLOPS, StepRunner
    from repro_torch.train.trainer import train

    B_max = max(r[2] for r in runs)
    data = ROOT / "build" / key / "data"
    t0 = time.perf_counter()
    pipe = DataPipeline.build(str(data), n_functions=n_functions, seq_len=S, batch_size=B_max,
                              vocab_size=cfg.vocab_size, work_fn=cli.make_work_fn(cfg))
    try:
        host = [pipe.peek_batch(k) for k in range(steps)]
    finally:
        pipe.close()
    if not all(torch.equal(b["labels"], torch.roll(b["tokens"], -1, 1)) for b in host):
        fail(f"{key}: the pipeline's labels are not the tokens rolled by one")
    res = {"seq": S, "layers": cfg.n_layers, "steps": steps,
           "data_s": time.perf_counter() - t0}
    for tag, dtype, B, micro in runs:
        batches = [{k: v[i:i + B] for k, v in b.items()}
                   for b in host for i in range(0, B_max, B)][:steps]
        tokens = B * S
        run = RunConfig(model=cfg, shape=ShapeConfig(f"{key}_{tag}", S, B, "train"),
                        sharding="ddp", param_dtype=dtype, activation_dtype=dtype,
                        microbatch=micro if micro > 1 else 0)
        opt = AdamWConfig(lr=1e-3, warmup_steps=max(1, steps // 2), total_steps=steps)
        want = train_launches_per_step(cfg, B, S, micro)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the state trains the model drawn from seed 0 itself (what
        # ``train``'s seed 0 draws), so that one copy of the parameters is
        # on the card: mixtral_train's f32 state takes 50.7 GB of it
        model = build_model(cfg, seed=0, dtype=getattr(torch, dtype), device="cuda")
        model.requires_grad_(True)
        state = {"params": model, "opt": init_opt_state(dict(model.named_parameters()))}
        ops.reset_launch_counts()
        dtypes, real = set(), ts.adamw_update

        def spy(c, grads, opt_state, params):
            dtypes.update(str(g.dtype) for g in grads.values())
            return real(c, grads, opt_state, params)

        ts.adamw_update = spy
        t0 = time.perf_counter()
        try:
            state, tlog = train(model, run, opt, iter(batches), steps=steps, log_every=1,
                                state=state)
            torch.cuda.synchronize()
        finally:
            ts.adamw_update = real
        counts = dict(ops.launch_counts)
        per_step = {k: counts.get(k, 0) / steps for k in want}
        losses = [m["loss"] for m in tlog.metrics]
        p50 = tlog.telemetry["step_time_p50"]
        r = {"dtype": dtype, "batch": B, "microbatch": micro,
             "wall_s": time.perf_counter() - t0,
             "launches": counts, "launches_per_step": per_step, "launches_per_step_want": want,
             "losses": losses, "step_time_p50_ms": p50 * 1e3, "tokens_per_s": tokens / p50,
             "model_flops_per_step": model_flops(cfg, tokens),
             "mfu": model_flops(cfg, tokens) / (p50 * DEFAULT_PEAK_FLOPS),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "adamw_grad_dtypes": sorted(dtypes), "telemetry": tlog.telemetry}
        log(f"{key} {tag}: launches {counts} over {steps} steps, per step {per_step}, "
            f"p50 {p50 * 1e3:.1f} ms, losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"peak {r['peak_mem_gib']:.1f} GiB")
        if per_step != {k: float(v) for k, v in want.items()}:
            fail(f"{key} {tag}: kernel launches per step {per_step}, expected {want}")
        if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            fail(f"{key} {tag}: losses {losses}")
        if cfg.moe is not None:     # the aux reported, and C12 under accumulation
            r["aux_losses"] = [m.get("aux_loss") for m in tlog.metrics]
            if not all(a is not None and math.isfinite(a) and a > 0 for a in r["aux_losses"]):
                fail(f"{key} {tag}: aux losses {r['aux_losses']}")
            if micro > 1 and dtypes != {"torch.float32"}:
                fail(f"{key} {tag}: AdamW got gradients of dtypes {sorted(dtypes)}, not f32")
        runner = StepRunner(model, run, opt)
        r["profile"] = profile_steps(torch, runner, state,
                                     [runner.place_batch(b) for b in batches[:n_prof]], p50)
        res[tag] = r
        del state, runner, model, tlog
        torch.cuda.empty_cache()
    a = res["a"]
    res.update(batch=a["batch"], launches=a["launches"], first_loss=a["losses"][0],
               last_loss=a["losses"][-1], step_time_p50_ms=a["step_time_p50_ms"],
               tokens_per_s=a["tokens_per_s"], mfu=a["mfu"],
               model_flops_per_step=a["model_flops_per_step"])
    log(f"{key}: " + json.dumps({k: v for k, v in res.items() if k not in ("a", "b")}))
    rec[key] = res


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
DDP_TRAJ_REL = 1e-4                  # ddp: rank 0's losses against one process, 6 steps
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
    """One rank of a ``spawn_ddp`` run: join the group, run ``mode`` (path,
    profile), and write the result where ``spec["out"]`` says.  The
    profile ranks then run phase fsdp's run (c) (``spec["fsdp"]``) and
    fsdp_path (``spec["refs"]``) when asked."""
    import torch.distributed as dist

    from repro_torch.distributed import maybe_initialize_distributed

    info = maybe_initialize_distributed()
    res = {"rank": info.rank, "world": info.world, "backend": info.backend,
           "device": str(info.device)}
    if mode == "path":
        res.update(ddp_path_rank(torch, info, spec))
    if mode == "profile":       # then, after ddp's timed steps, phase fsdp's and fsdp_path's
        res.update(ddp_profile_rank(torch, info, spec))
        if "fsdp" in spec:
            res["fsdp_run"] = fsdp_resume_rank(torch, info, spec)
        if "refs" in spec:
            res["fsdp_path"] = fsdp_path_rank(torch, info, spec)
    Path(spec["out"]).write_text(json.dumps(res))
    dist.destroy_process_group()


# fsdp_path's vocab (ddp_path keeps bert's 32768): odd, so that under fsdp
# mlm.out_bias (V,) has no dimension the 2 ranks divide and stays whole,
# and the psum bucket runs on the card too
FSDP_PATH_VOCAB = 32767
FSDP_MICRO = 2                       # the microbatch-2 branches' count
FSDP_MICRO_STEPS = 2                 # their steps, and ddp's at microbatch 2 beside them
FSDP_COUNTS = ("param_all_gather", "grad_reduce_scatter", "grad_all_reduce")


def _ddp_path_setup(torch, sharding="ddp"):
    from repro_torch.configs import default_run_config, get_config
    from repro_torch.configs.base import LayerSpec, ShapeConfig, uniform_schedule
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config("bert-mlm-120m")
    cfg = dataclasses.replace(cfg, schedule=uniform_schedule(2, LayerSpec()),
                              vocab_size=FSDP_PATH_VOCAB if sharding == "fsdp" else cfg.vocab_size)
    run = default_run_config(cfg, ShapeConfig(f"{sharding}_path", 512, 8, "train"),
                             sharding=sharding)
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


def one_process_refs(torch, tag, cfg, run, opt, batches):
    """One process on the card, the references of a 2-rank path check: the
    gradients of batch 0 (8 rows) and of the same global loss on the
    ranks' row shards, written where the ranks read them (returned paths),
    the gap between the two, and 5 steps of losses."""
    import numpy as np

    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import (init_state, make_grad_fn, make_train_step,
                                              shard_sums)

    run = dataclasses.replace(run, sharding="ddp")
    model = build_model(cfg, seed=0, device="cuda")
    on = [{k: v.cuda() for k, v in b.items()} for b in batches]
    refs = {"batch": ROOT / "build" / "ddp" / f"{tag}_ref_batch.npz",
            "shards": ROOT / "build" / "ddp" / f"{tag}_ref_shards.npz"}
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
    return refs, one


def check_ddp_path(torch, rec):
    """bert-mlm-120m at full width, 2 layers, f32, global batch 8 x 512
    with ragged masks: two ranks on the card over gloo against one
    process on the card (the summed gradients against the same global
    loss on the ranks' row shards and against the 8-row batch; 5 steps
    of losses), one all-reduce per bucket per step, every hook once."""
    refs, one = one_process_refs(torch, "path", *_ddp_path_setup(torch))
    want = one["losses"]
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


def fsdp_path_rank(torch, info, spec):
    """fsdp_path on one rank: the gathered gradients of batch 0 at each
    bucket size of DDP_PATH_MB (donate_gather) against the one-process
    ones (``spec["refs"]``: shards, batch); ddp at microbatch 2
    (gradients, FSDP_MICRO_STEPS steps), the reference of the
    microbatch-2 branches; then each branch's state bytes and its steps
    at 25 MB (5 at one microbatch), the collectives of each step
    counted."""
    import numpy as np

    from repro_torch.distributed import gradsync
    from repro_torch.distributed.sharding import ParallelPlan
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import (init_state, make_grad_fn, make_train_step,
                                              shard_state)

    t0 = time.perf_counter()
    cfg, run, opt, batches = _ddp_path_setup(torch, "fsdp")
    model = build_model(cfg, seed=0, device=info.device)
    rows = slice(info.rank * 4, (info.rank + 1) * 4)
    local = [{k: v[rows].to(info.device) for k, v in b.items()} for b in batches]
    refs = {}
    for name, path in spec["refs"].items():
        with np.load(path) as z:
            refs[name] = {k: torch.from_numpy(z[k]).to(info.device) for k in z.files}

    def counted(fn):
        gradsync.reset_counts()
        res = fn()
        return res, [gradsync.counts[k] for k in FSDP_COUNTS]

    def worst(ours, ref):
        err = leaf_errors(ours, ref)
        k = max(err, key=err.get)
        return {"max_rel_err": err[k], "worst_leaf": k}

    out = {"grads": {}, "runs": {}}
    for mb in DDP_PATH_MB:
        plan = ParallelPlan.for_run(run, info.world, grad_bucket_mb=mb)
        sp = plan.scatter_plan(model)
        params = shard_state(init_state(model, run, seed=None),
                             plan.shard_layout(model, info.rank))["params"]
        (loss, grads, _), c = counted(lambda: make_grad_fn(model, run, plan)(params, local[0]))
        out["grads"][str(mb)] = {"grad_sync": plan.grad_sync, "counts": c, "loss": loss.item(),
                                 "n": [len(sp.scatter), len(sp.psum)],
                                 **{name: worst(grads, ref) for name, ref in refs.items()}}
        del params, grads
    micro = dataclasses.replace(run, microbatch=FSDP_MICRO)
    ddp = dataclasses.replace(micro, sharding="ddp")
    dplan = ParallelPlan.for_run(ddp, info.world)
    _, dgrads, _ = make_grad_fn(model, ddp, dplan)(init_state(model, ddp, seed=None)["params"],
                                                   local[0])
    state = init_state(model, ddp, seed=None)
    step = make_train_step(model, ddp, opt, dplan)
    out["ddp_micro2_losses"] = [step(state, b)[1]["loss"].item()
                                for b in local[1:1 + FSDP_MICRO_STEPS]]
    del state, step
    for name, r, kw in (("donate_gather", run, {}), ("gather_once", micro, {}),
                        ("free_after_use", micro, {"free_after_use": True})):
        plan = ParallelPlan.for_run(r, info.world, **kw)
        sp = plan.scatter_plan(model)
        layout = plan.shard_layout(model, info.rank)
        res = {"micro": r.microbatch or 1, "grad_sync": plan.grad_sync,
               "n": [len(sp.scatter), len(sp.psum)],
               "want_bytes": sp.scatter_bytes // 2 + sp.psum_bytes}
        if res["micro"] > 1:
            params = shard_state(init_state(model, r, seed=None), layout)["params"]
            (_, grads, _), res["grad_counts"] = counted(
                lambda: make_grad_fn(model, r, plan)(params, local[0]))
            res["vs_ddp"] = worst(grads, dgrads)
            del params, grads
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        state = shard_state(init_state(model, r, seed=None), layout)
        torch.cuda.synchronize()
        res["allocated_delta"] = torch.cuda.memory_allocated() - before
        res["state_bytes"] = {"params": sum(p.nbytes for p in state["params"].parameters()),
                              **{m: sum(v.nbytes for v in state["opt"][m].values())
                                 for m in ("mu", "nu")}}
        step = make_train_step(model, r, opt, plan)
        res["losses"], res["step_counts"] = [], []
        for b in local[1:] if res["micro"] == 1 else local[1:1 + FSDP_MICRO_STEPS]:
            (state, m), c = counted(lambda: step(state, b))
            res["losses"].append(m["loss"].item())
            res["step_counts"].append(c)
        out["runs"][name] = res
        del state, step
    out["seconds"] = time.perf_counter() - t0
    return out


def check_fsdp_path(torch, rec):
    """bert-mlm-120m at full width, 2 layers, f32, vocab FSDP_PATH_VOCAB,
    the 8 x 512 ragged batch: 2 ZeRO-3 ranks on the card over gloo
    (phase ddp's profile ranks, ``run_ddp(..., with_fsdp_path=True)``)
    against one process on the card: gradients (against the 8-row batch
    and the ranks' row shards, both at DDP_GRAD_REL: on an H100 the batch
    read 5.7e-6 at vocab 32767, where ddp_path's vocab 32768 read 1.04e-5;
    PERF.md §6), losses, the collectives of each branch, each rank's
    state bytes."""
    raw = rec.pop("_fsdp_path", None)
    if raw is None:
        fail("phase fsdp_path runs in phase ddp's profile ranks: select both")
    ranks, one = raw
    want = one["losses"]
    bad = []
    for r in ranks:
        if r.get("backend") != "gloo" or r.get("world") != DDP_WORLD:
            bad.append(f"rank {r.get('rank')}: backend {r.get('backend')}, "
                       f"world {r.get('world')}")
        for mb, g in r["grads"].items():
            ns, npsum = g["n"]
            if g["grad_sync"] != "scatter_overlap" or npsum < 1 \
                    or g["counts"] != [ns, ns, npsum] \
                    or not g["shards"]["max_rel_err"] <= DDP_GRAD_REL \
                    or not g["batch"]["max_rel_err"] <= DDP_GRAD_REL \
                    or not abs(g["loss"] - one["loss"]) <= DDP_LOSS_REL * abs(one["loss"]):
                bad.append(f"rank {r.get('rank')} at {mb} MB: {g}")
        for name, x in r["runs"].items():
            ns, npsum = x["n"]
            # free_after_use gathers again in each microbatch's backward
            expect = [2 * x["micro"] * ns, x["micro"] * ns, npsum] \
                if name == "free_after_use" else [ns, ns, npsum]
            ref = want if x["micro"] == 1 else r["ddp_micro2_losses"]
            x["losses_max_rel_err"] = max_rel(x["losses"], ref)
            if x["grad_sync"] != "scatter_overlap" \
                    or x["step_counts"] != [expect] * len(ref) \
                    or x.get("grad_counts", expect) != expect \
                    or not x.get("vs_ddp", {"max_rel_err": 0})["max_rel_err"] <= DDP_GRAD_REL \
                    or not x["losses_max_rel_err"] <= DDP_LOSS_REL \
                    or set(x["state_bytes"].values()) != {x["want_bytes"]}:
                bad.append(f"rank {r.get('rank')} {name}: {x}")
    if ranks[0]["grads"][str(DDP_PATH_MB[0])]["n"][0] <= \
            ranks[0]["grads"][str(DDP_PATH_MB[-1])]["n"][0]:
        bad.append("the small bucket size did not make more scatter buckets")
    if any(ranks[0]["runs"][n]["losses"] != ranks[1]["runs"][n]["losses"]
           for n in ranks[0]["runs"]):
        bad.append("the ranks' losses differ")
    log(f"fsdp_path: one process {one}; ranks {json.dumps(ranks)}")
    if bad:
        fail("fsdp_path: " + "; ".join(bad))
    rec["fsdp_path"] = {"one_process": one, "ranks": ranks}


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


def fsdp_resume_rank(torch, info, spec):
    """Phase fsdp's run (c) on one rank of the profile spawn, after ddp's
    timed steps: the CLI's ``main`` in this rank (its process group the
    spawn's) resumed from run (a)'s step-3 checkpoint; its losses and step
    p50 (the host is quiet by then), and whether its final checkpoint and
    sidecar equal (a)'s bit for bit."""
    from repro_torch.launch import train as cli
    from repro_torch.train import checkpoint as ckpt

    f = spec["fsdp"]
    _, log_c = cli.main(f["args"] + ["--ckpt-dir", f["ck_c"], "--resume"])
    out = {"c_losses": {s: m["loss"] for s, m in zip(log_c.steps, log_c.metrics)},
           "c_step_p50_ms": log_c.telemetry["step_time_p50"] * 1e3}
    da, dc = (ckpt.step_dir(f[k], f["steps"]) for k in ("ck_a", "ck_c"))
    name = f"shard-{info.rank:05d}"
    out["c_same"] = _shards_equal(Path(da) / f"{name}.npz", Path(dc) / f"{name}.npz") and \
        sidecars(da, DDP_WORLD)[info.rank] == sidecars(dc, DDP_WORLD)[info.rank]
    return out


# the ddp phase's witness of f32 reordering: 6 steps at the launcher's
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
                            text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                            start_new_session=True)
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
    [kernels], [telemetry], [plan], [dist] and [memory] fields."""
    import re

    losses = {int(m.group(1)): float(m.group(2))
              for m in re.finditer(r"^\s+step\s+(\d+) loss=(\S+)", stdout, re.M)}
    fields = {}
    for line in stdout.splitlines():
        if line.startswith("[kernels]"):
            fields["launches"] = json.loads(line.split("launches=", 1)[1])
        elif line.startswith(("[gradsync]", "[telemetry]", "[plan] mode=", "[dist]",
                               "[memory]")):
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


def run_ddp(torch, rec, B=16, S=512, n_functions=CLI_FUNCTIONS, steps=6, with_fsdp=False,
            with_fsdp_path=False):
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
    bit for bit; the gaps to the batch's order recorded.  ``with_fsdp``:
    phase fsdp's runs, ``--sharding fsdp`` with the same flags: (a) by
    torchrun beside ddp's (c); (c) the CLI's ``main`` resumed from (a)'s
    step-3 checkpoint in the profile ranks after their timed steps; phase
    fsdp gates them.  ``with_fsdp_path``: the profile ranks then run
    fsdp_path, on one-process references made here beside runs (c);
    phase fsdp_path gates it."""
    import os
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
    # test_two_processes_stopped_and_resumed_repeat_their_losses.  Phase
    # fsdp's run (a) runs in a thread beside them too (its steps' time is
    # taken again, alone, in the profile ranks), and its run (c) in the
    # profile ranks after their timed steps: a torchrun of its own costs
    # about 45 s.
    # the copies are hard links: a run writes each file to a temporary name
    # and renames it, so (c) never writes into (a)'s files, and the disk
    # takes 4 GB fewer writes (a run after many writes reads slower)
    link = dict(copy_function=os.link)
    shutil.copytree(ckpt.step_dir(str(ck_a), half), ckpt.step_dir(str(ck_b), half), **link)
    ck_args = base + ["--batch", str(B), "--ckpt-dir", str(ck_b), "--ckpt-every", str(half)]
    runs = {}

    def torchrun_job(key, args):
        try:
            runs[key] = torchrun_train(args, key)
        except Exception as e:      # noqa: BLE001 - reported below
            runs[key + "_error"] = repr(e)

    jobs = [("c", ck_args + ["--resume"])]
    fsdp = None
    if with_fsdp:
        fsdp = {"dirs": [work / "fsdp-a", work / "fsdp-c"], "half": half, "steps": steps,
                "B": B, "S": S,
                "args": base + ["--batch", str(B), "--sharding", "fsdp", "--ckpt-every",
                                str(half)]}
        for d in fsdp["dirs"]:
            shutil.rmtree(d, ignore_errors=True)
        jobs.append(("fsdp-a", fsdp["args"] + ["--ckpt-dir", str(fsdp["dirs"][0])]))
    threads = [threading.Thread(target=torchrun_job, args=job, daemon=True) for job in jobs]
    for thread in threads:
        thread.start()
    ops.reset_launch_counts()
    _, log_one = cli.main(base + ["--batch", str(B * DDP_WORLD)])
    one = [m["loss"] for m in log_one.metrics]
    res["one_process"] = {"losses": one, "beside": "runs c",
                          "step_time_p50_ms": log_one.telemetry["step_time_p50"] * 1e3}
    plain, shards = order_witness(torch, B, S, steps, WITNESS_LR)
    if with_fsdp_path:
        path_refs, path_one = one_process_refs(torch, "fsdp_path",
                                               *_ddp_path_setup(torch, "fsdp"))
    torch.cuda.empty_cache()
    for thread in threads:
        thread.join()
    if fsdp is not None:
        fsdp["a"] = runs.get("fsdp-a") or fail(f"fsdp a: {runs.get('fsdp-a_error')}")
        if fsdp["a"][0] != 0:
            fail(f"fsdp a: torchrun exited {fsdp['a'][0]}: {fsdp['a'][2].stderr[-2000:]} "
                 f"{[r['stderr'][-2000:] for r in fsdp['a'][1]]}")
        shutil.copytree(ckpt.step_dir(str(fsdp["dirs"][0]), half),
                        ckpt.step_dir(str(fsdp["dirs"][1]), half), **link)

    l0 = res["rank0"]["losses"]
    rel = max_rel(l0, one) if None not in l0 else math.inf
    res["traj_max_rel_err"] = rel
    if not rel <= DDP_TRAJ_REL:
        fail(f"ddp a: rank 0 losses {l0} vs one process {one}: max rel {rel}")
    if "c_error" in runs:
        fail(f"ddp c: {runs['c_error']}")
    rc_c, ranks_c, out = runs["c"]
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
               launches=parsed[0][1].get("launches", {}),
               memory=[memory_fields(f.get("memory")) for _, f in parsed])
    spec = {"batch": B, "seq": S, "steps": steps, "lr": WITNESS_LR}
    if fsdp is not None:
        spec["fsdp"] = {"args": fsdp["args"], "steps": steps,
                        **{k: str(d) for k, d in zip(("ck_a", "ck_c"), fsdp["dirs"])}}
    if with_fsdp_path:
        spec["refs"] = {k: str(v) for k, v in path_refs.items()}
    res["profile"] = spawn_ddp("profile", spec)
    if fsdp is not None:
        fsdp["ranks"] = [p.pop("fsdp_run") for p in res["profile"]]
        rec["_fsdp_raw"] = fsdp
    if with_fsdp_path:
        for v in path_refs.values():
            v.unlink()
        path_ranks = [{k: p[k] for k in ("rank", "world", "backend")} | p.pop("fsdp_path")
                      for p in res["profile"]]
        rec["_fsdp_path"] = path_ranks, path_one
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


def memory_fields(line):
    """{state_mb, peak_allocated_gib} of a launcher's [memory] line."""
    return {"state_mb": float((_field(line, "state") or "nan").rstrip("MB")),
            "peak_allocated_gib": float((_field(line, "peak_allocated") or "nan")
                                        .rstrip("GiB"))}


def tiles_once(global_shape, parts):
    """Whether the boxes ``parts`` ({start, shape}) lie inside
    ``global_shape``, are pairwise disjoint and fill it."""
    vol = lambda shape: math.prod(int(x) for x in shape)
    for p in parts:
        if any(a < 0 or a + n > g for a, n, g in zip(p["start"], p["shape"], global_shape)):
            return False
    if sum(vol(p["shape"]) for p in parts) != vol(global_shape):
        return False
    for i, p in enumerate(parts):
        for q in parts[i + 1:]:
            if all(max(a, b) < min(a + m, b + n) for a, m, b, n in
                   zip(p["start"], p["shape"], q["start"], q["shape"])):
                return False
    return True


def sidecars(d, world):
    """Each rank's ``shard-<r>.subshards.json`` of checkpoint directory ``d``
    (None where missing)."""
    out = []
    for r in range(world):
        f = Path(d) / f"shard-{r:05d}.subshards.json"
        out.append(json.loads(f.read_text()) if f.exists() else None)
    return out


def check_fsdp(torch, rec):
    """Phase fsdp: the ZeRO-3 runs that phase ddp ran (``run_ddp(...,
    with_fsdp=True)``), against ddp's: run (a)'s plan, losses, collectives
    and launches a step, its sub-shard checkpoints, run (c)'s resume;
    run (c)'s step p50 and tokens/s (in the quiet profile ranks) beside
    ddp's, each rank's state and peak memory beside ddp's run (a)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.train import checkpoint as ckpt

    raw = rec.pop("_fsdp_raw", None)
    if raw is None:
        fail("phase fsdp runs its CLI inside phase ddp (after ddp's run (a)): select both")
    ddp = rec["ddp"]
    steps, half, B, S = raw["steps"], raw["half"], raw["B"], raw["S"]
    ck_a = raw["dirs"][0]
    want = train_launches_per_step(get_config("bert-mlm-120m"), B, S)
    rc, ranks_a, _ = raw["a"]
    parsed = [_cli_lines(r["stdout"]) for r in ranks_a]
    res = {"batch_per_rank": B, "world": DDP_WORLD, "seq": S, "steps": steps,
           "launches_per_step_want": want}
    bad = []
    for r, (losses, f) in enumerate(parsed):
        plan, gs = f.get("plan", ""), f.get("gradsync", "")
        ns, npsum = _field(gs, "scatter_buckets"), _field(gs, "psum_buckets")
        per_step = {k: f.get("launches", {}).get(k, 0) / steps for k in want}
        res[f"rank{r}"] = {"losses": [losses.get(i) for i in range(1, steps + 1)],
                           "launches_per_step": per_step, "lines": f,
                           **memory_fields(f.get("memory"))}
        if f"process {r}/{DDP_WORLD} backend=gloo" not in f.get("dist", ""):
            bad.append(f"rank {r} [dist]: {f.get('dist')}")
        if "mode=fsdp" not in plan or _field(plan, "grad_sync") != "scatter_overlap" \
                or _field(plan, "gather") is None:
            bad.append(f"rank {r} [plan]: {plan}")
        if ns is None or _field(gs, "per_step") != f"{ns}/{ns}/{npsum}":
            bad.append(f"rank {r} [gradsync]: {gs}")
        if per_step != {k: float(v) for k, v in want.items()}:
            bad.append(f"rank {r}: launches per step {per_step}, expected {want}")
    l0, l1 = res["rank0"]["losses"], res["rank1"]["losses"]
    if l0 != l1:
        bad.append(f"the ranks' losses differ: {l0} {l1}")
    one, dl = ddp["one_process"]["losses"], ddp["rank0"]["losses"]
    res["traj_max_rel_err"] = max_rel(l0, one) if None not in l0 else math.inf
    res["vs_ddp_max_rel_err"] = max_rel(l0, dl) if None not in l0 else math.inf
    if not res["traj_max_rel_err"] <= DDP_TRAJ_REL or \
            not res["vs_ddp_max_rel_err"] <= DDP_LOSS_REL:
        bad.append(f"rank 0 losses {l0}: one process {one}, ddp (a) {dl}")
    for step in (half, steps):
        subs = sidecars(ckpt.step_dir(str(ck_a), step), DDP_WORLD)
        if None in subs or subs[0].keys() != subs[1].keys() or not subs[0]:
            bad.append(f"step {step}: sidecars {[s is not None for s in subs]}")
            continue
        untiled = [k for k in subs[0] if not tiles_once(
            subs[0][k]["global_shape"], subs[0][k]["parts"] + subs[1][k]["parts"])]
        res[f"sidecar_leaves_step{step}"] = len(subs[0])
        if untiled:
            bad.append(f"step {step}: parts do not tile {untiled[:5]}")
    for r, rank in enumerate(raw["ranks"]):
        # (c) in full precision, (a) as its launcher printed it
        losses = {int(i): float(f"{x:.4f}") for i, x in rank["c_losses"].items()}
        want_c = {i: parsed[r][0].get(i) for i in range(half + 1, steps + 1)}
        if losses != want_c or not rank["c_same"]:
            bad.append(f"fsdp c: rank {r} resumed losses {losses} != uninterrupted "
                       f"{want_c}, or its final checkpoint differs ({rank['c_same']})")
    if bad:
        fail("fsdp: " + "; ".join(bad))
    res["resume_bit_exact"] = True
    for d in raw["dirs"]:
        shutil.rmtree(d, ignore_errors=True)
    f0 = parsed[0][1]
    p50 = raw["ranks"][0]["c_step_p50_ms"] / 1e3
    res.update(step_time_p50_ms=p50 * 1e3, global_tokens_per_s=B * S * DDP_WORLD / p50,
               c_step_p50_ms=[rank["c_step_p50_ms"] for rank in raw["ranks"]],
               plan=f0.get("plan"), gradsync_line=f0.get("gradsync"),
               launches=f0.get("launches", {}),
               memory=[memory_fields(f.get("memory")) for _, f in parsed],
               cli_step_p50_ms_beside_c=float(_field(f0.get("telemetry"), "step_p50")
                                              .rstrip("ms")),
               ddp_beside={"profile_step_p50_ms": [p["step_p50_ms"] for p in ddp["profile"]],
                           "cli_step_p50_ms": ddp.get("step_time_p50_ms"),
                           "memory": ddp.get("memory")})
    log("fsdp: " + json.dumps({k: v for k, v in res.items() if k not in ("rank0", "rank1")}))
    rec["fsdp"] = res


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    """(bound ms, what bounds it) of a flash backward: five products per
    unmasked (query, key) pair and head, S, dK and dQ of 2 D flops, dP and
    dV of 2 Dv (v's head dim, ``v_dim``), at ``peak`` (default
    ``_flash_peak``); q, dq, k, dk (D wide) and o, do, v, dv (Dv wide)
    moved once in the inputs' dtype, the f32 lse read once."""
    B, S, H, D = q.shape
    Hkv, Dv = k.shape[2], v_dim(D)
    pairs = attn_pairs(S, causal, window)
    nbytes = q.element_size() * B * S * 2 * (H + Hkv) * (D + Dv) + 4 * B * H * S
    return _bound(2 * B * H * (3 * D + 2 * Dv) * pairs, nbytes, peak or _flash_peak(q))


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
    plain version's autograd (eager, a group of kv heads at a time:
    ``plain_ms_by_groups``) and SDPA's backward op: ``ms`` and
    ``library_ms`` by CUDA-graph replay, ``library_eager_ms`` SDPA's
    autograd backward by back-to-back eager calls, and the kernel's
    device time split by its device kernels.  With a (causal) window SDPA
    takes it as an explicit mask, and its backward op takes no mask:
    ``library_ms`` is then its autograd backward, eager."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    ratio = checked(f"flash_bwd {what}", flash_bwd_reading(torch, q, k, v, do, causal, window))
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    run = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    ms, call_ms = time_ms(torch, run, iters, reps)
    plain_ms = plain_ms_by_groups(torch, q, k, v, dict(causal=causal, window=window), do)
    f32 = q.dtype == torch.float32
    plain_err = None
    if f32:     # the plain f32 version against the gate's f64 reference
        plain_err = plain_f32_err_by_groups(torch, q, k, v, do, causal, window)
        log(f"time flash_bwd {what}: the plain f32 version against f64: max_abs_err "
            f"{plain_err:.3e}, error/limit {plain_err / F32_TOL:.3f}")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    mask = None if window is None else window_mask(torch, q.shape[1], window, q.device)
    with torch.enable_grad():
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               is_causal=causal and mask is None,
                                               enable_gqa=q.shape[2] != k.shape[2])
    lib_eager = eager_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    del o_lib
    if window is not None:
        lib_ms, lib_call_ms = lib_eager, None
    else:
        try:
            lib_ms, lib_call_ms = time_ms(torch, sdpa_bwd(torch, q, k, v, do, causal),
                                          iters, reps)
        except RuntimeError as e:       # an op this card, graph or shape (v at its own
            # head dim) refuses: SDPA's autograd backward, whatever backend it picks
            log(f"time flash_bwd {what}: SDPA's backward op not timed ({e}); its autograd "
                f"backward, eager, instead")
            lib_ms, lib_call_ms = lib_eager, None
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
           "plain": "autograd backward, eager, a group of kv heads at a time (CUDA events)",
           "library": f"aten._scaled_dot_product_{lib_op}_attention_backward by CUDA-graph "
                      "replay (K, V repeated to H heads); library_eager_ms: SDPA's "
                      "autograd backward, eager" if window is None else
                      "SDPA's autograd backward with the window as a boolean mask, eager"}
    log(f"time flash_bwd {what}: {res}")
    return res


def flash_bound(q, k, causal, lse, peak=None, window=None):
    """(bound ms, what bounds it) of a flash forward: 2 (D + Dv) flops
    per unmasked (query, key) pair and head (Q K^T at D, P V at v's head
    dim Dv, ``v_dim``) at ``peak`` (default ``_flash_peak``), q, k (D
    wide), v and o (Dv wide) and the f32 lse moved once in the inputs'
    dtype."""
    B, S, H, D = q.shape
    Hkv, Dv = k.shape[2], v_dim(D)
    pairs = attn_pairs(S, causal, window)
    nbytes = q.element_size() * B * S * (H + Hkv) * (D + Dv) + (4 * B * H * S if lse else 0)
    return _bound(2 * B * H * (D + Dv) * pairs, nbytes, peak or _flash_peak(q))


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
                   "gemma": time_gemma_kernels(torch, checked, gen),
                   "gemma2": time_gemma2_kernels(torch, checked, gen),
                   "zamba2": time_zamba2_kernels(torch, checked, gen),
                   "llama3": time_llama3_kernels(torch, checked, gen),
                   "deepseek": time_deepseek_kernels(torch, checked, gen)}


def plain_ms_by_groups(torch, q, k, v, opts, do=None):
    """ms of the plain version on q, k, v a group of kv heads at a time
    (``head_groups``; gemma2's 32 heads at S 8192 whole would hold 2.1
    billion f32 scores a tensor), summed over the groups, the better of
    two passes: with ``do`` its autograd backward alone (each group's
    forward untimed), else its forward; CUDA events around each group."""
    from repro_torch.kernels import ref

    B, S, H, _ = q.shape
    Hkv = k.shape[2]
    rep_ = H // Hkv
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = None
    for _ in range(2):
        total = 0.0
        for g0, g1 in head_groups(B, S, Hkv, rep_):
            xs = [x.detach().requires_grad_(do is not None)
                  for x in (q[:, :, g0 * rep_:g1 * rep_], k[:, :, g0:g1], v[:, :, g0:g1])]
            if do is None:
                a.record()
                ref.flash_attention_ref(*xs, **opts)
                b.record()
            else:
                with torch.enable_grad():
                    o = ref.flash_attention_ref(*xs, **opts)
                a.record()
                torch.autograd.grad(o, xs, do[:, :, g0 * rep_:g1 * rep_])
                b.record()
                del o
            b.synchronize()
            total += a.elapsed_time(b)
        best = total if best is None else min(best, total)
    return best


def plain_f32_err_by_groups(torch, q, k, v, do, causal, window):
    """max |error| of the plain version's f32 autograd backward against
    the same function in f64 (``_attention_grads64``), a group of kv heads
    at a time (``head_groups``)."""
    from repro_torch.kernels import ref

    B, S, H, _ = q.shape
    Hkv = k.shape[2]
    rep_ = H // Hkv
    err = 0.0
    for g0, g1 in head_groups(B, S, Hkv, rep_):
        xs = [x.detach().requires_grad_(True)
              for x in (q[:, :, g0 * rep_:g1 * rep_], k[:, :, g0:g1], v[:, :, g0:g1])]
        dog = do[:, :, g0 * rep_:g1 * rep_]
        with torch.enable_grad():
            got = torch.autograd.grad(
                ref.flash_attention_ref(*xs, causal=causal, window=window), xs, dog)
        want = _attention_grads64(torch, *xs, dog, causal, window)
        err = max(err, *((g.double() - w).abs().max().item() for g, w in zip(got, want)))
        del got, want
    return err


def time_gemma2_kernels(torch, checked, gen, iters=3, reps=2):
    """gemma2-27b's attention kernels (32 q / 16 kv heads of 128, causal,
    the query scale 144^-0.5): the flash backward with the softcap 50 at
    the gemma2_train shape B 1 x S 8192, bf16 and f32, with the local
    layers' window of 4096 and without, each beside the same body without
    the cap on the same inputs; the flash forward at an 8192-token prefill
    (bf16, window and none); the paged decode of its global layers, 8 slots
    of about 5000 tokens.  No PyTorch call takes a softcap (SDPA has
    none): no library time.  The plain times go a group of kv heads at a
    time (``plain_ms_by_groups``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention_fwd

    none = "none (SDPA takes no softcap)"
    mk = lambda shape, dtype: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    out = {"flash_bwd": {}, "flash_fwd": {}}
    B, S, H, Hkv, D, _ = GEMMA2_TRAIN_ATTN
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        q, do = (mk((B, S, H, D), dtype) for _ in range(2))
        k, v = (mk((B, S, Hkv, D), dtype) for _ in range(2))
        rows = out["flash_bwd"].setdefault(dname, {})
        for window in (GEMMA2_WINDOW, None):
            for cap in (GEMMA2_SOFTCAP, 0.0):
                what = f"gemma2 train {dname} window={window} softcap={cap}"
                opts = dict(causal=True, window=window, softcap=cap, scale=GEMMA2_SCALE)
                ratio = checked(f"flash_bwd {what}", flash_bwd_reading(
                    torch, q, k, v, do, True, window, cap, GEMMA2_SCALE))
                o, lse = flash_attention_fwd(q, k, v, return_lse=True, **opts)
                run = lambda: flash_attention_bwd(q, k, v, o, lse, do, **opts)
                ms, call_ms = time_ms(torch, run, iters, reps)
                bound = flash_bwd_bound(q, k, True, window=window)
                row = {"shape": list(q.shape) + [Hkv], "dtype": dname, "window": window,
                       "softcap": cap, "ms": ms, "call_ms": call_ms, "bound_ms": bound[0],
                       "bound_by": bound[1], "err_over_limit": ratio}
                if dtype == torch.float32:
                    row["bound_simt_ms"] = flash_bwd_bound(q, k, True, PEAK_F32_FLOPS, window)[0]
                if cap:
                    row.update(plain_ms=plain_ms_by_groups(torch, q, k, v, opts, do),
                               library_ms=None, library=none,
                               plain="autograd backward, a kv head at a time (CUDA events)",
                               by_kernel=device_ms_by_kernel(torch, run, n=3))
                del o, lse
                rows[("window" if window else "global") + ("" if cap else "_nocap")] = row
                log(f"time flash_bwd {what}: {row}")
        del q, k, v, do
    q = mk((B, S, H, D), torch.bfloat16)
    k, v = (mk((B, S, Hkv, D), torch.bfloat16) for _ in range(2))
    for window in (GEMMA2_WINDOW, None):
        what = f"gemma2 prefill window={window}"
        opts = dict(causal=True, window=window, softcap=GEMMA2_SOFTCAP, scale=GEMMA2_SCALE)
        ratio = checked(f"flash {what}", flash_reading(torch, q, k, v, **opts))
        ms, call_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, **opts), iters, reps)
        bound = flash_bound(q, k, True, lse=False, window=window)
        row = {"shape": list(q.shape) + [Hkv], "dtype": "bfloat16", "window": window,
               "softcap": GEMMA2_SOFTCAP, "ms": ms, "call_ms": call_ms,
               "plain_ms": plain_ms_by_groups(torch, q, k, v, opts), "library_ms": None,
               "library": none, "bound_ms": bound[0], "bound_by": bound[1],
               "err_over_limit": ratio}
        out["flash_fwd"]["window" if window else "global"] = row
        log(f"time flash {what}: {row}")
    del q, k, v
    # paged: the 23 global layers' decode tick, 8 slots x ~5000 live
    # tokens; two disjoint table sets alternate, 165 MB of K/V each
    B, H, Hkv, D, P, maxp, R = 8, 32, 16, 128, 16, 336, 2
    NP = 1 + R * B * maxp
    kp, vp = (mk((NP, P, Hkv, D), torch.bfloat16) for _ in range(2))
    q = mk((B, H, D), torch.bfloat16)
    pos = torch.tensor([5000 - 9 * b for b in range(B)], dtype=torch.int32, device="cuda")
    ids = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(5)) + 1
    tables = [ids[r * B * maxp:(r + 1) * B * maxp].reshape(B, maxp).int().cuda()
              for r in range(R)]
    live = int((pos + 1).sum())
    nbytes = live * 2 * Hkv * D * 2 + 2 * q.numel() * 2 + B * (maxp + 1) * 4
    b = _bound(4 * H * D * live, nbytes, PEAK_BF16_FLOPS)
    opts = dict(softcap=GEMMA2_SOFTCAP, scale=GEMMA2_SCALE)
    ratio = max(checked(f"paged gemma2 table set {r}",
                        paged_reading(torch, q, kp, vp, tables[r], pos, **opts))
                for r in range(R))
    it = iter(range(10**9))
    run = lambda: paged_attention_fwd(q, kp, vp, tables[next(it) % R], pos, **opts)
    ms, call_ms = time_ms(torch, run)
    plain_ms, _ = time_ms(torch, lambda: ref.paged_attention_ref(
        q, kp, vp, tables[next(it) % R], pos, **opts))
    out["paged"] = {"shape": [B, H, Hkv, D, P], "live_tokens": live, "softcap": GEMMA2_SOFTCAP,
                    "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": b[0], "bound_by": b[1], "err_over_limit": ratio,
                    "by_kernel": device_ms_by_kernel(torch, run)}
    log(f"time paged gemma2: {out['paged']}")
    return out


def flash_fwd_row(torch, checked, what, q, k, v, window, lse, iters, reps):
    """The causal flash forward at one shape against the gate, its bound,
    the plain version (a group of kv heads at a time by CUDA events:
    ``plain_ms_by_groups``) and SDPA (enable_gqa; a window as an explicit
    boolean mask), the kernel and SDPA by CUDA-graph replay."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_fwd

    ratio = checked(f"flash {what}", flash_reading(torch, q, k, v, True, window))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None if window is None else window_mask(torch, q.shape[1], window, q.device)
    run = lambda: flash_attention_fwd(q, k, v, causal=True, window=window, return_lse=lse)
    ms, call_ms = time_ms(torch, run, iters, reps)
    plain_ms = plain_ms_by_groups(torch, q, k, v, dict(causal=True, window=window))
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
           "plain": "a group of kv heads at a time (CUDA events)",
           "library": "SDPA" + (" with the window as a boolean mask" if window else "")}
    log(f"time flash {what}: {row}")
    return row


def time_zamba2_kernels(torch, checked, gen, iters=3, reps=2):
    """zamba2-2.7b's attention kernels at head dim 80 (MHA, 32 heads,
    causal): the flash forward (with lse) and backward at the zamba2_train
    shape B 1 x S 4096 in bf16 and f32, the forward at a 4000-token bf16
    prefill, and the paged decode of its 9 shared invocations, 8 slots of
    about 2000 tokens, in bf16.  SDPA takes head dim 80: it is each
    row's yardstick (the paged row's on the slots' keys gathered into a
    padded batch beforehand, with a boolean mask of the live keys)."""
    mk = lambda shape, dtype: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    out = {"flash_train": {}}
    B, S, H, Hkv, D, _ = ZAMBA2_TRAIN_ATTN
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        q, do = (mk((B, S, H, D), dtype) for _ in range(2))
        k, v = (mk((B, S, Hkv, D), dtype) for _ in range(2))
        what = f"zamba2 train {dname}"
        out["flash_train"][dname] = {
            "fwd": flash_fwd_row(torch, checked, what, q, k, v, None, True, iters, reps),
            "bwd": time_flash_bwd(torch, checked, what, q, k, v, do, True, None, iters, reps)}
        del q, k, v, do
    q = mk((B, 4000, H, D), torch.bfloat16)
    k, v = (mk((B, 4000, Hkv, D), torch.bfloat16) for _ in range(2))
    out["flash_prefill"] = flash_fwd_row(torch, checked, "zamba2 prefill", q, k, v, None,
                                         False, iters, reps)
    del q, k, v
    # paged: a tick's shared invocation, 8 slots x ~2000 live tokens; two
    # disjoint table sets alternate, 84 MB of K/V each (L2: 50 MB)
    out["paged"] = paged_row(torch, checked, mk, "zamba2", 32, 32, 80, seed=6)
    return out


def time_deepseek_kernels(torch, checked, gen, iters=3, reps=2):
    """deepseek-v2-lite's MLA attention (q/k head dim 192 laid out as 256,
    v 128; 16 / 16 heads, causal): the flash forward (with lse) and
    backward at its train shape B 1 x S 4096 in bf16 and f32, and the
    forward at a 4000-token bf16 prefill, each against the bound on the
    true work (``flash_bound``: 2 B H (S^2 / 2) (192 + 128) flops
    forward; ``flash_bwd_bound``: 2 B H (S^2 / 2) (3 192 + 2 128)
    backward), the plain version and SDPA at E 192, Ev 128 (its backward
    op where it takes the shape, else its autograd backward)."""
    mk = lambda shape, dtype: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    out = {"flash_train": {}}
    B, S, H, Hkv, D, _ = DEEPSEEK_TRAIN_ATTN
    Dv = v_dim(D)
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        q, k = mk((B, S, H, D), dtype), mk((B, S, Hkv, D), dtype)
        v, do = mk((B, S, Hkv, Dv), dtype), mk((B, S, H, Dv), dtype)
        what = f"deepseek train {dname}"
        out["flash_train"][dname] = {
            "fwd": flash_fwd_row(torch, checked, what, q, k, v, None, True, iters, reps),
            "bwd": time_flash_bwd(torch, checked, what, q, k, v, do, True, None, iters, reps)}
        del q, k, v, do
    q, k = mk((B, 4000, H, D), torch.bfloat16), mk((B, 4000, Hkv, D), torch.bfloat16)
    v = mk((B, 4000, Hkv, Dv), torch.bfloat16)
    out["flash_prefill"] = flash_fwd_row(torch, checked, "deepseek prefill", q, k, v, None,
                                         False, iters, reps)
    return out


def paged_row(torch, checked, mk, what, H, Hkv, D, P=16, maxp=128, L=2000, seed=6):
    """The bf16 paged decode of one layer's tick, 8 slots of about ``L``
    live tokens, against the gate, its bound, the plain version and SDPA
    (``enable_gqa``) on the slots' keys gathered into a padded (B, Hkv, L,
    D) batch beforehand with a boolean mask of the live keys; two disjoint
    table sets alternate."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_fwd

    B, R = 8, 2
    NP = 1 + R * B * maxp
    kp, vp = (mk((NP, P, Hkv, D), torch.bfloat16) for _ in range(2))
    q = mk((B, H, D), torch.bfloat16)
    pos = torch.tensor([L - 9 * b for b in range(B)], dtype=torch.int32, device="cuda")
    ids = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(seed)) + 1
    tables = [ids[r * B * maxp:(r + 1) * B * maxp].reshape(B, maxp).int().cuda()
              for r in range(R)]
    live = int((pos + 1).sum())
    nbytes = live * 2 * Hkv * D * 2 + 2 * q.numel() * 2 + B * (maxp + 1) * 4
    b = _bound(4 * H * D * live, nbytes, PEAK_BF16_FLOPS)
    ratio = max(checked(f"paged {what} table set {r}",
                        paged_reading(torch, q, kp, vp, tables[r], pos)) for r in range(R))
    it = iter(range(10**9))
    run = lambda: paged_attention_fwd(q, kp, vp, tables[next(it) % R], pos)
    ms, call_ms = time_ms(torch, run)
    plain_ms, _ = time_ms(torch, lambda: ref.paged_attention_ref(
        q, kp, vp, tables[next(it) % R], pos))
    # SDPA on the same keys of table set 0, gathered into (B, Hkv, L, D)
    # beforehand; a boolean mask of each slot's live keys
    Lk = int(pos.max()) + 1
    keys = lambda pool: pool[tables[0].long()].flatten(1, 2)[:, :Lk].transpose(1, 2)
    kd, vd = keys(kp), keys(vp)
    live_mask = (torch.arange(Lk, device="cuda")[None] <= pos[:, None].long())[:, None, None]
    lib_ms, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=live_mask, enable_gqa=H != Hkv))
    row = {"shape": [B, H, Hkv, D, P], "live_tokens": live, "ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library": "SDPA on the slots' keys gathered into a padded (B, Hkv, L, D) "
                      "batch beforehand, a boolean mask of the live keys",
           "bound_ms": b[0], "bound_by": b[1], "err_over_limit": ratio,
           "by_kernel": device_ms_by_kernel(torch, run)}
    log(f"time paged {what}: {row}")
    return row


def time_llama3_kernels(torch, checked, gen, iters=3, reps=2):
    """llama3-8b's attention kernels (32 q / 8 kv heads of 128, rep 4,
    causal, no softcap) at the llama3_train shape B 1 x S 8192: the flash
    forward (with lse) and backward in bf16 and f32 (``flash_fwd_row``,
    ``time_flash_bwd``: the plain version a kv head at a time, its
    (1, 4, 8192, 8192) f32 scores a group); the paged decode at 8 slots
    of about 2000 tokens at llama3's rep 4 and qwen2-72b's rep 8 (64 / 8
    heads)."""
    mk = lambda shape, dtype: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    out = {"flash_train": {}}
    B, S, H, Hkv, D, _ = LLAMA3_TRAIN_ATTN
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        q, do = (mk((B, S, H, D), dtype) for _ in range(2))
        k, v = (mk((B, S, Hkv, D), dtype) for _ in range(2))
        what = f"llama3 train {dname}"
        out["flash_train"][dname] = {
            "fwd": flash_fwd_row(torch, checked, what, q, k, v, None, True, iters, reps),
            "bwd": time_flash_bwd(torch, checked, what, q, k, v, do, True, None, iters, reps)}
        del q, k, v, do
    out["paged_rep4"] = paged_row(torch, checked, mk, "llama3 rep 4", 32, 8, 128, seed=7)
    out["paged_rep8"] = paged_row(torch, checked, mk, "qwen2 rep 8", 64, 8, 128, seed=8)
    return out


def time_gemma_kernels(torch, checked, gen, iters=5, reps=3):
    """gemma3-4b's attention kernels at head dim 256, causal: the flash
    forward at a 2048-token serve prefill in bf16, with the local layers'
    window of 1024 and without; forward (with lse) and backward at the
    gemma_train shape (B 4 x S 2048) in bf16 and f32, window and none; the
    paged decode of its global layers, 8 slots of about 2000 tokens, in
    bf16.  SDPA (enable_gqa; the window as an explicit boolean mask) is
    the yardstick.  Fewer graph replays than the small shapes take."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_fwd

    fwd_row = lambda what, q, k, v, window, lse: flash_fwd_row(
        torch, checked, what, q, k, v, window, lse, iters, reps)
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
    ssm_serve, train, train_cli's run (a) and rank 0 of ddp's and fsdp's
    runs (a)),
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
                         "fsdp", "gemma_serve", "gemma_train", "gemma2_serve", "gemma2_train",
                         "zamba2_serve", "zamba2_train", "llama3_serve", "llama3_train",
                         "bert350_train", "mixtral_serve", "mixtral_train", "deepseek_serve",
                         "deepseek_train")}
    paths["ssm_train_bf16"] = rec.get("ssm_train", {}).get("c", {}).get("launches", {})
    paths["gemma_train_bf16"] = rec.get("gemma_train", {}).get("b", {}).get("launches", {})
    paths["gemma2_train_bf16"] = rec.get("gemma2_train", {}).get("b", {}).get("launches", {})
    paths["zamba2_train_bf16"] = rec.get("zamba2_train", {}).get("b", {}).get("launches", {})
    paths["llama3_train_bf16"] = rec.get("llama3_train", {}).get("b", {}).get("launches", {})
    paths["mixtral_train_bf16"] = rec.get("mixtral_train", {}).get("b", {}).get("launches", {})
    paths["deepseek_train_bf16"] = rec.get("deepseek_train", {}).get("b", {}).get("launches", {})
    gm, gm2, zm = t.get("gemma", {}), t.get("gemma2", {}), t.get("zamba2", {})
    l3 = t.get("llama3", {})
    l3train = l3.get("flash_train", {})     # {dtype: {fwd, bwd}}
    ds = t.get("deepseek", {})
    dstrain = ds.get("flash_train", {})     # {dtype: {fwd, bwd}}
    ztrain = zm.get("flash_train", {})     # {dtype: {fwd, bwd}}
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
                                                       for d, v in gtrain.items()},
                                 "gemma2_prefill_shape": gm2.get("flash_fwd"),
                                 "zamba2_train_shape": {d: r.get("fwd") for d, r in ztrain.items()},
                                 "zamba2_prefill_shape": zm.get("flash_prefill"),
                                 "llama3_train_shape": {d: r.get("fwd")
                                                        for d, r in l3train.items()},
                                 "deepseek_mla_train_shape": {d: r.get("fwd")
                                                              for d, r in dstrain.items()},
                                 "deepseek_mla_prefill_shape": ds.get("flash_prefill")},
             "paged_attention": {**{k: t.get("paged", {}).get(k)
                                    for k in ("call_ms", "host_call_ms", "by_kernel")},
                                 "gemma_shape": gm.get("paged"),
                                 "gemma2_shape": gm2.get("paged"),
                                 "zamba2_shape": zm.get("paged"),
                                 "llama3_rep4_shape": l3.get("paged_rep4"),
                                 "qwen2_rep8_shape": l3.get("paged_rep8")},
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
                                                           for d, v in gtrain.items()},
                                     "gemma2_train_shape_softcap": gm2.get("flash_bwd"),
                                     "zamba2_train_shape": {d: r.get("bwd")
                                                            for d, r in ztrain.items()},
                                     "llama3_train_shape": {d: r.get("bwd")
                                                            for d, r in l3train.items()},
                                     "deepseek_mla_train_shape": {d: r.get("bwd")
                                                                  for d, r in dstrain.items()}},
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
            "gemma2_path_max_rel_err": rec.get("gemma2_path", {}).get("max_rel_err"),
            "gemma2_serve": {k: rec.get("gemma2_serve", {}).get(k)
                             for k in keys + ("peak_mem_gib",)},
            "gemma2_tick_device_busy_ms":
                rec.get("gemma2_serve_decode_profile", {}).get("device_busy_ms"),
            "gemma2_prefill_8192_device_busy_ms":
                rec.get("gemma2_serve_prefill_profile", {}).get("device_busy_ms"),
            "gemma2_train_path_rel_err": rec.get("gemma2_train_path", {}).get("rel_err"),
            "gemma2_train": {tag: {k: rec.get("gemma2_train", {}).get(tag, {}).get(k) for k in (
                "step_time_p50_ms", "tokens_per_s", "mfu", "peak_mem_gib")} | {
                "device_busy_ms": rec.get("gemma2_train", {}).get(tag, {}).get(
                    "profile", {}).get("device_busy_ms")} for tag in ("a", "b")},
            "gemma2_softcap_bwd_ms": {d: {k: r.get("ms") for k, r in rows.items()}
                                      for d, rows in rec.get("time", {}).get("gemma2", {}).get(
                                          "flash_bwd", {}).items()},
            "zamba2_path_max_rel_err": rec.get("zamba2_path", {}).get("max_rel_err"),
            "zamba2_train_path_rel_err": rec.get("zamba2_train_path", {}).get("rel_err"),
            "zamba2_serve": {k: rec.get("zamba2_serve", {}).get(k)
                             for k in keys + ("peak_mem_gib",)},
            "zamba2_tick_device_busy_ms":
                rec.get("zamba2_serve_decode_profile", {}).get("device_busy_ms"),
            "zamba2_prefill_4000_device_busy_ms":
                rec.get("zamba2_serve_prefill_profile", {}).get("device_busy_ms"),
            "zamba2_train": {tag: {k: rec.get("zamba2_train", {}).get(tag, {}).get(k) for k in (
                "step_time_p50_ms", "tokens_per_s", "mfu", "peak_mem_gib")} | {
                "device_busy_ms": rec.get("zamba2_train", {}).get(tag, {}).get(
                    "profile", {}).get("device_busy_ms")} for tag in ("a", "b")},
            "zamba2_d80_ms": {
                **{f"{d}_{kind}": r.get(kind, {}).get("ms") for d, r in rec.get("time", {}).get(
                    "zamba2", {}).get("flash_train", {}).items() for kind in ("fwd", "bwd")},
                "prefill": rec.get("time", {}).get("zamba2", {}).get("flash_prefill", {}).get("ms"),
                "paged": rec.get("time", {}).get("zamba2", {}).get("paged", {}).get("ms")},
            "llama3_serve": {k: rec.get("llama3_serve", {}).get(k)
                             for k in keys + ("peak_mem_gib",)},
            "llama3_tick_device_busy_ms":
                rec.get("llama3_serve_decode_profile", {}).get("device_busy_ms"),
            "llama3_prefill_4096_device_busy_ms":
                rec.get("llama3_serve_prefill_profile", {}).get("device_busy_ms"),
            "llama3_train": {tag: {k: rec.get("llama3_train", {}).get(tag, {}).get(k) for k in (
                "step_time_p50_ms", "tokens_per_s", "mfu", "peak_mem_gib")} | {
                "device_busy_ms": rec.get("llama3_train", {}).get(tag, {}).get(
                    "profile", {}).get("device_busy_ms")} for tag in ("a", "b")},
            "llama3_train_path_rel_err": rec.get("llama3_train_path", {}).get("rel_err"),
            "mixtral_serve": {k: rec.get("mixtral_serve", {}).get(k)
                              for k in keys + ("peak_mem_gib",)},
            "mixtral_tick_device_busy_ms":
                rec.get("mixtral_serve_decode_profile", {}).get("device_busy_ms"),
            "mixtral_prefill_4096_device_busy_ms":
                rec.get("mixtral_serve_prefill_profile", {}).get("device_busy_ms"),
            "mixtral_train": {tag: {k: rec.get("mixtral_train", {}).get(tag, {}).get(k) for k in (
                "step_time_p50_ms", "tokens_per_s", "mfu", "peak_mem_gib")} | {
                "device_busy_ms": rec.get("mixtral_train", {}).get(tag, {}).get(
                    "profile", {}).get("device_busy_ms")} for tag in ("a", "b")},
            "moe_paths": {k: {f: rec.get(k, {}).get(f) for f in (
                "max_rel_err", "rel_err", "router_calls", "min_topk_gap")}
                for k in ("mixtral_path", "phi35_path", "mixtral_train_path")},
            "qwen2_path_max_rel_err": rec.get("qwen2_path", {}).get("max_rel_err"),
            "llama3_attn_ms": {
                **{f"{d}_{kind}": r.get(kind, {}).get("ms") for d, r in rec.get("time", {}).get(
                    "llama3", {}).get("flash_train", {}).items() for kind in ("fwd", "bwd")},
                **{k: rec.get("time", {}).get("llama3", {}).get(k, {}).get("ms")
                   for k in ("paged_rep4", "paged_rep8")}},
            "bert350_train": {k: rec.get("bert350_train", {}).get(k) for k in (
                "step_time_p50_ms", "tokens_per_s", "mfu", "first_loss", "last_loss",
                "peak_mem_gib")},
            "bert_max_batch": {a: {k: r.get(k) for k in ("fit", "oom", "memory_model_card",
                                                         "paper")}
                               for a, r in rec.get("bert_max_batch", {}).get("archs", {}).items()},
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
            "fsdp": {k: rec.get("fsdp", {}).get(k) for k in (
                "step_time_p50_ms", "global_tokens_per_s", "traj_max_rel_err",
                "vs_ddp_max_rel_err", "resume_bit_exact", "memory")},
            "ddp_memory": rec.get("ddp", {}).get("memory"),
            "fsdp_path_max_rel_err": {name: max((g[name]["max_rel_err"] for r in rec.get(
                "fsdp_path", {}).get("ranks", []) for g in r["grads"].values()), default=None)
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
    ap.add_argument("--max-batch-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--sass-counts", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sass_counts:        # one library's reading for the build gate
        sys.path.insert(0, str(ROOT / "src"))
        print(json.dumps(sass_counts(args.sass_counts)))
        return
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
    if args.max_batch_worker:   # phase bert_max_batch's search
        max_batch_worker(torch)
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
    sass = start_sass_reads()
    against_libs = load_against(rec, against, against_builds)
    steps = {"kernels": check_kernels,
             "faults": lambda torch, rec: check_faults(torch, rec, fault_builds),
             "path": lambda torch, rec: check_engine_path(torch, rec, "path", cpu_refs),
             "serve": run_serve,
             "ssm_path": lambda torch, rec: check_engine_path(torch, rec, "ssm_path", cpu_refs),
             "ssm_serve": lambda torch, rec: run_serve(torch, rec, arch="mamba2-130m",
                                                       key="ssm_serve"),
             "train_path": lambda torch, rec: check_train_path(torch, rec, cpu_refs),
             "train": run_train, "train_cli": run_train_cli,
             "ssm_train_path": lambda torch, rec: check_lm_train_path(
                 torch, rec, "ssm_train_path", cpu_refs),
             "ssm_train": run_ssm_train,
             "gemma_path": lambda torch, rec: check_engine_path(torch, rec, "gemma_path",
                                                                cpu_refs),
             "gemma_serve": run_gemma_serve,
             "gemma_train_path": lambda torch, rec: check_lm_train_path(
                 torch, rec, "gemma_train_path", cpu_refs),
             "gemma_train": run_gemma_train,
             "gemma2_path": lambda torch, rec: check_engine_path(torch, rec, "gemma2_path",
                                                                 cpu_refs),
             "gemma2_serve": run_gemma2_serve,
             "gemma2_train_path": lambda torch, rec: check_lm_train_path(
                 torch, rec, "gemma2_train_path", cpu_refs),
             "gemma2_train": run_gemma2_train,
             "zamba2_path": lambda torch, rec: check_engine_path(torch, rec, "zamba2_path",
                                                                 cpu_refs),
             "zamba2_train_path": lambda torch, rec: check_lm_train_path(
                 torch, rec, "zamba2_train_path", cpu_refs),
             "zamba2_serve": run_zamba2_serve, "zamba2_train": run_zamba2_train,
             "qwen2_path": lambda torch, rec: check_engine_path(torch, rec, "qwen2_path",
                                                                cpu_refs),
             "llama3_train_path": lambda torch, rec: check_lm_train_path(
                 torch, rec, "llama3_train_path", cpu_refs),
             "llama3_serve": run_llama3_serve, "llama3_train": run_llama3_train,
             "mixtral_path": lambda torch, rec: check_engine_path(torch, rec, "mixtral_path",
                                                                  cpu_refs),
             "phi35_path": lambda torch, rec: check_engine_path(torch, rec, "phi35_path",
                                                                cpu_refs),
             "mixtral_train_path": lambda torch, rec: check_lm_train_path(
                 torch, rec, "mixtral_train_path", cpu_refs),
             "mixtral_serve": run_mixtral_serve, "mixtral_train": run_mixtral_train,
             "deepseek_path": lambda torch, rec: check_engine_path(torch, rec, "deepseek_path",
                                                                   cpu_refs),
             "deepseek_train_path": lambda torch, rec: check_lm_train_path(
                 torch, rec, "deepseek_train_path", cpu_refs),
             "deepseek_serve": run_deepseek_serve, "deepseek_train": run_deepseek_train,
             "bert350_train": run_bert350_train,
             "bert_max_batch": lambda torch, rec: run_bert_max_batch(torch, rec, cpu_refs),
             "ddp_path": check_ddp_path, "fsdp_path": check_fsdp_path,
             "ddp": lambda torch, rec: run_ddp(torch, rec, with_fsdp="fsdp" in phases,
                                               with_fsdp_path="fsdp_path" in phases),
             "fsdp": check_fsdp, "time": time_kernels}
    for ph in PHASES[1:]:
        if sass is not None and PHASES.index(ph) >= PHASES.index(SASS_GATED_BY):
            wgmma_build_facts(rec, sass_results(sass))
            sass = None
        if ph in phases:
            t0 = time.perf_counter()
            with card_lock(torch, ph in CARD_LOCK_PHASES):
                if against_libs and ph in AGAINST_PHASES:
                    run_against(torch, rec, ph, steps[ph], against_libs)
                else:
                    steps[ph](torch, rec)
            rec.setdefault("phase_s", {})[ph] = time.perf_counter() - t0
            log(f"phase {ph}: {rec['phase_s'][ph]:.1f}s")
            if fault_builds:
                pump_fault_builds(fault_builds)
    if sass is not None:
        wgmma_build_facts(rec, sass_results(sass))
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

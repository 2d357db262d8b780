#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,train_path,train
    python3 chip_smoke.py --phases build,ssm_path,ssm_serve
    python3 chip_smoke.py --phases build,train_cli
    python3 chip_smoke.py --phases build,serve,train,time \
        --against parent=build/parent/flash_attention.cu

Phases (any failure exits non-zero before the last line):
  build       build the CUDA kernels from src/repro_torch/kernels/csrc/;
              the bf16 flash forward and backward, the bf16 SSD body's
              product passes and the bf16 paged body must run on wgmma and
              TMA alone (SASS: HGMMA and UTMALDG, no HMMA; no ptxas C7520)
  kernels     hold each kernel (forward and backward) against its plain
              PyTorch version (backward: the plain version's autograd) on
              the card, f32 and bf16, at the stated tolerances, up to the
              decode tick's, the training step's and the SSM prefill's
              shapes
  faults      planted faults: builds copies of the kernels with one known
              bug each and checks that the kernel gate fails them
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
  train_cli   bert-mlm-120m at full width and depth, f32 (the launcher's
              defaults), batch 32 x 512 from the DataPipeline over a
              3000-function corpus, through repro_torch.launch.train.main:
              (a) 20 steps with the R3 autotune; (b) the same run with
              sharded checkpoints, stopped after the step-10 one; (d) that
              checkpoint resumed through runner.resume and TrainLoop with
              the device prefetch 4 deep, and (c) through a fresh main
              (depth 2), whose losses at steps 11-20 must each equal (a)'s
              bit for bit; launch counts per step as in train, every batch
              placed by the device prefetch, the loss falling; the
              prefetch's batches equal to the host's at depths 2 and 4; then
              python -m repro_torch.launch.train as a subprocess
  time        each kernel at its path's shapes against its plain version,
              its bound and a PyTorch call computing the same function
              (SDPA and its backward op, F.cross_entropy; none computes
              SSD) as a yardstick: device time per call (CUDA-graph
              replay) and time per back-to-back call

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
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
PHASES = ("build", "kernels", "faults", "path", "serve", "ssm_path", "ssm_serve", "train_path",
          "train", "train_cli", "time")
AGAINST_PHASES = ("serve", "ssm_serve", "train", "time")   # the phases --against runs again

# H100 SXM peaks (NVIDIA data sheet, dense): the bounds below use them
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12                      # f32 outside the tensor cores
PEAK_BYTES = 3.35e12

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


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------

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
]


# bert-mlm-120m's attention at the train phases' batch 32 x 512: the shape
# the train and train_cli phases give the flash forward and backward
BERT_ATTN = (32, 512, 12, 12, 64, False)

# the backward kernel: (B, S, H, Hkv, D, causal); no window or softcap yet
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
]

XENT_CASES = [  # (T, V)
    (3904, 32768),   # one loss chunk of the train phase: 32 x 122 rows
    (37, 1000),      # a ragged last tile
    (5, 1001),       # V odd: the scalar loads
    (300, 4099),     # one column past a tile
    (64, 50),        # less than one tile
]

SSD_CASES = [  # (B, S, H, P, G, N, chunk, scale of A)
    (1, 1024, 24, 64, 1, 128, 256, 1.0),    # mamba2-130m's prefill at S = 1024
    (1, 321, 24, 64, 1, 128, 256, 1.0),     # a full chunk and a ragged one of 65
    (1, 65, 24, 64, 1, 128, 256, 1.0),      # the shortest serve prompt: one partial chunk
    (2, 300, 8, 16, 2, 16, 32, 1.0),        # the reduced shapes, G = 2, ragged
    (2, 200, 8, 32, 4, 64, 64, 1.0),        # G = 4, the 64-row tiles at chunk 64
    (2, 250, 6, 16, 3, 8, 96, 1.0),         # chunk 96 (32-row tiles past the first), N 8
    (1, 600, 4, 64, 1, 128, 256, 50.0),     # decays past f32's exp range above the diagonal
    # the bf16 body's edges (64-row tiles, 64-step key tiles, chunks of 64-256)
    (1, 1024, 80, 64, 1, 64, 256, 1.0),     # zamba2-2.7b's N 64 at H 80
    (2, 700, 8, 64, 2, 128, 256, 1.0),      # B 2, G 2, S ragged inside a 64-row tile
    (1, 40, 24, 64, 1, 128, 256, 1.0),      # S < 64: one partial tile
    (1, 512, 24, 64, 1, 128, 256, 1.0),     # S an exact multiple of the chunk
    (2, 200, 8, 64, 4, 64, 64, 1.0),        # chunk 64: one tile a chunk, G 4
    (1, 333, 6, 64, 3, 128, 128, 1.0),      # chunk 128, G 3
    (1, 450, 4, 64, 2, 64, 192, 1.0),       # chunk 192
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


def flash_bwd_reading(torch, q, k, v, do, causal):
    """The backward kernel (fed the forward kernel's o and lse) against
    the autograd of the plain version on the f32 inputs.  bf16 limit per
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

    o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    fn = lambda q_, k_, v_: ref.flash_attention_ref(q_, k_, v_, causal=causal)
    _, want = _plain_grads(torch, fn, (q, k, v), do)
    dname = str(q.dtype).split(".")[1]
    if dname == "float32":
        return max((gate(torch, g, w, None, dname) for g, w in zip(got, want)),
                   key=lambda r: r[1])
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep_ = H // Hkv
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))   # (B,h,S,D)
    kf, vf = (x.repeat_interleave(rep_, dim=1) for x in (kf, vf))
    s = (qf @ kf.transpose(-1, -2)) * D**-0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1),
                          ref.NEG_INF)
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
    """x, B, C normal in ``dtype``; dt softplus of a normal; A < 0 with
    |A| log-uniform in [0.01, 1] times the case's scale, so some heads
    carry their state across chunks and some forget within a few steps."""
    B, S, H, P, G, N, _, scale = case
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    u = torch.rand(H, generator=gen, device="cuda")
    A = -torch.exp(math.log(0.01) * u) * scale
    dt = torch.nn.functional.softplus(mk(B, S, H))
    return mk(B, S, H, P).to(dtype), dt, A, mk(B, S, G, N).to(dtype), mk(B, S, G, N).to(dtype)


def ssd_limits(torch, x, dt, A, N, chunk):
    """(u_out, y's factor of want_abs, the state's factor of want_abs) of
    the ssd_scan gate (see SSD_REL) for a call on these inputs."""
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
            B, S, H, Hkv, D, causal = case
            q, k, v = _flash_inputs(torch, (B, S, H, Hkv, D), dtype, gen)
            do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
            if case == BERT_ATTN and want("flash_attention"):    # its forward too
                out.append(("flash_attention", case, *flash_reading(torch, q, k, v, causal)))
            out.append(("flash_attention_bwd", case,
                        *flash_bwd_reading(torch, q, k, v, do, causal)))
    if want("fused_xent", "fused_xent_bwd"):
        for case in XENT_CASES:
            fwd, bwd = xent_readings(torch, *_xent_inputs(torch, case, dtype, gen))
            out.append(("fused_xent", case, *fwd))
            out.append(("fused_xent_bwd", case, *bwd))
    if want("ssd_scan"):
        for case in SSD_CASES:
            out.append(("ssd_scan", case, *ssd_reading(
                torch, *_ssd_inputs(torch, case, dtype, gen), case[6])))
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
# text, its replacement); the gate of one of those kernels must fail each
# on at least one case
FAULTS = [
    ("flash_attention", ("flash_attention",),
     "bf16 body drops keys 0-63 of every row that sees more than 512 keys",
     "s[x] = hopper::exp2_approx(s[x] - m[(x >> 1) & 1]);",
     "s[x] = k0 + (x / 4) * 8 + 2 * t < 64 && kt_hi * BK > 512 ? 0.f : "
     "hopper::exp2_approx(s[x] - m[(x >> 1) & 1]);"),
    ("paged_attention", ("paged_attention",),
     "combine merges at most 8 splits (the first 512 keys at P 16 in bf16)",
     "s1 = j_hi / p.pps;", "s1 = min(j_hi / p.pps, s0 + 7);"),
    ("paged_attention", ("paged_attention",), "wgmma body: the mask lets in the key after pos",
     "const int key_hi = min(pos, (j1 + 1) * P - 1);",
     "const int key_hi = min(pos + 1, (j1 + 1) * P - 1);"),
    ("paged_attention", ("paged_attention",),
     "wgmma body: the partial max goes to the combine in base 2",
     "p.part_ml[prow * 2] = m[r] * LN2;  // the combine's natural-log units",
     "p.part_ml[prow * 2] = m[r];  // the combine's natural-log units"),
    ("fused_xent", ("fused_xent", "fused_xent_bwd"), "forward skips the last vocab tile",
     "for (int c0 = 0; c0 < V; c0 += TILE) {  // vocab tiles, in order",
     "for (int c0 = 0; c0 + TILE < V; c0 += TILE) {  // vocab tiles, in order"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "dq drops the contribution of k tile 0 when there are more",
     "dp[x] = s[x] * (dp[x] - dl[(x >> 1) & 1]);  // dq: dS = P (dP - Delta)",
     "dp[x] = i == 0 && n_tiles > 1 ? 0.f : s[x] * (dp[x] - dl[(x >> 1) & 1]);  "
     "// dq: dS = P (dP - Delta)"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "dkdv skips the last rep head of each kv head",
     "const int n_iter = rep * nq;  // the ring runs over rep heads x q tiles",
     "const int n_iter = (rep > 1 ? rep - 1 : rep) * nq;  // the ring runs over rep heads x q tiles"),
    ("ssd_scan", ("ssd_scan",), "the state is carried without its exp(acs_L) decay",
     "if (n < N) st[n * PC + tx] = carry * st[n * PC + tx] + acc[i];",
     "if (n < N) st[n * PC + tx] = st[n * PC + tx] + acc[i];"),
    ("ssd_scan", ("ssd_scan",), "bf16 body: the carry pass drops the chunks' decay",
     "d[k] = dec[(c0 + k) * p.H];  // exp(acs_L) of the chunk",
     "d[k] = 1.f;  // exp(acs_L) of the chunk"),
    ("ssd_scan", ("ssd_scan",), "bf16 body: the state pass drops the lo half of w x",
     "hopper::wgmma_ss<64, 1, 1>(u[mt], da, hopper::desc_sw128(xl + kk * 2048, BOX, 1024), 1);",
     "// the lo half dropped"),
    ("ssd_scan", ("ssd_scan",), "bf16 body: the out pass drops exp(acs_l) from C . state",
     "for (int x = 0; x < 32; ++x) y[x] *= expf(acs_row[(x >> 1) & 1]);",
     "for (int x = 0; x < 32; ++x) y[x] *= 1.f;"),
]
KERNELS = ("flash_attention", "flash_attention_bwd", "paged_attention", "fused_xent",
           "fused_xent_bwd", "ssd_scan")


def _start_nvcc(src, lib):
    from repro_torch.kernels import _build

    return subprocess.Popen(_build.nvcc_command(src, lib), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def start_fault_builds():
    """Write the faulty sources under build/kernels/faults/ and start one
    nvcc for each; returns {index in FAULTS: (process, library path)}."""
    from repro_torch.kernels import _build

    d = _build.BUILD_DIR / "faults"
    d.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, _, _, old, new) in enumerate(FAULTS):
        text = (_build.CSRC / f"{name}.cu").read_text()
        if text.count(old) != 1:
            fail(f"faults: {name}.cu does not hold {old!r} once; update FAULTS")
        src, lib = d / f"{name}-{i}.cu", d / f"lib{name}-{i}.so"
        src.write_text(text.replace(old, new))
        procs[i] = (_start_nvcc(src, lib), lib)
    return procs


def check_faults(torch, rec, procs):
    import ctypes

    from repro_torch.kernels import _build

    res = []
    for i, (name, kernels, bug, _, _) in enumerate(FAULTS):
        proc, lib = procs[i]
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"faults: the faulty {name} did not build:\n{out}")
        good = _build.swap(name, ctypes.CDLL(str(lib)))
        try:
            readings = [r for r in kernel_readings(torch, "bfloat16", only=kernels)
                        if r[0] in kernels]
        finally:
            _build.swap(name, good)
        caught = [(case, err, ratio) for _, case, err, ratio in readings if ratio > 1.0]
        old = max(err for _, _, err, _ in readings)
        log(f"faults: {name} with '{bug}': gate fails {len(caught)} of {len(readings)} "
            f"cases {[c[0] for c in caught]}, max error/limit "
            f"{max(r[3] for r in readings):.2f}; max abs error {old:.3e} against the "
            f"former flat {OLD_BF16_TOL}")
        if not caught:
            fail(f"faults: the kernel gate passed {name} with the planted bug '{bug}'")
        finite = lambda x: x if math.isfinite(x) else str(x)   # the record stays JSON
        res.append({"kernel": name, "bug": bug, "cases_failed": len(caught),
                    "cases": len(readings), "failed": [list(map(str, c)) for c in caught],
                    "max_ratio": finite(max(r[3] for r in readings)),
                    "max_abs_err": finite(old), "former_flat_gate_fails": old > OLD_BF16_TOL})
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
    (mma.sync)."""
    import re

    res, fn = {}, None
    for line in text.splitlines():
        if line.strip().startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            res[fn] = dict.fromkeys(("HGMMA", "UTMALDG", "UTMASTG", "HMMA"), 0)
        elif fn:
            for op in res[fn]:
                res[fn][op] += len(re.findall(rf"\b{op}\b", line))
    return res


def sass_counts(lib):
    """``parse_sass`` of a built library."""
    from repro_torch.kernels import _build

    return parse_sass(subprocess.run(
        [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout)


# the bf16 bodies' product passes, which must run on wgmma and TMA alone:
# (kernel source, a part of each of its functions' names)
WGMMA_FUNCTIONS = (("flash_attention", "flash_fwd_wgmma"), ("flash_attention_bwd", "dq_wgmma"),
                   ("flash_attention_bwd", "dkdv_wgmma"), ("ssd_scan", "ssd_state_wgmma"),
                   ("ssd_scan", "ssd_out_wgmma"), ("paged_attention", "paged_wgmma"))


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
    """The bf16 flash forward and backward, the bf16 SSD body and the
    bf16 paged body as built: ptxas's report (registers, spill bytes) and
    SASS counts of every instance of ``WGMMA_FUNCTIONS``.  Fails unless
    each runs on HGMMA and UTMALDG with no HMMA, or if ptxas serialized a
    wgmma (its warning C7520)."""
    from repro_torch.kernels import _build

    facts, faults = {}, []
    for name in dict(WGMMA_FUNCTIONS):
        ptxas = rec["ptxas"].get(name, {})
        sass = sass_counts(_build._lib_path(_build.CSRC / f"{name}.cu"))
        for _, part in (f for f in WGMMA_FUNCTIONS if f[0] == name):
            for k, v in sass.items():
                if part in k:
                    log(f"{name} {k}: SASS {v}; ptxas {ptxas.get(k, 'not built in this run')}")
            faults += wgmma_route_faults(sass, part)
        faults += [w for w in ptxas.get("warnings", []) if "C7520" in w]
        facts[name] = {"ptxas": ptxas, "sass": sass}
    if faults:
        fail(f"the bf16 product kernels do not run on wgmma and TMA alone: {faults}")
    rec["flash_fwd_build"] = facts["flash_attention"]
    rec["flash_bwd_build"] = facts["flash_attention_bwd"]
    rec["ssd_build"] = facts["ssd_scan"]
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


def compare_engines(torch, name, cfg, prompts, max_new, want_launches):
    """The paged engine on cuda and on cpu (plain versions) from the same
    f32 weights: each prefill's and decode tick's logits within
    PATH_REL_TOL of the largest cpu logit, the same greedy tokens; the
    cuda run's kernel launches must equal ``want_launches(engine)`` and
    the cpu run must launch none."""
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
    eng_cpu, eng_gpu = (PagedServeEngine(m, run, page=16, n_pages=128, max_slots=4,
                                         max_pages=32) for m in (model_cpu, model_gpu))
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


def run_serve(torch, rec, seed=0, arch="starcoder2-3b", key="serve"):
    """``arch`` at full width and depth in bf16, random weights from
    ``seed``: 16 requests, prompts uniform in 65-1024 tokens, 32 new tokens
    each, all submitted at once; 8 slots, page 16.  Every layer's prefill
    and (attention models) decode must launch its kernel."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, random_prompts, serve

    cfg = get_config(arch)
    n_req, max_new = 16, 32
    t0 = time.perf_counter()
    eng = build_engine(cfg, device="cuda", dtype="bfloat16", seed=seed, page=16,
                       n_pages=1024, max_slots=8, max_pages=128)
    torch.cuda.synchronize()
    log(f"{key}: model + pools built in {time.perf_counter() - t0:.1f}s, "
        f"pools {eng.kv.pool_bytes() / 2**20:.0f} MiB")
    serve(eng, random_prompts(1, [64], cfg.vocab_size, seed + 99), max_new=2)  # warm-up
    lens = np.random.RandomState(seed).randint(65, 1025, n_req).tolist()
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
            {"flash_attention": n_layers * n_req, "paged_attention": n_layers * ticks})
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
    rec[f"{key}_prefill_profile"] = profile_prefill(torch, eng, cfg)
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


def train_launches_per_step(cfg, B, S):
    """Kernel launches of one train step: each layer's attention forward,
    again under remat, and its backward; each loss chunk's nll forward,
    again under its checkpoint, and its backward."""
    from repro_torch.train.train_step import loss_chunk_len

    n_chunks = -(-S // loss_chunk_len(B, S, cfg.vocab_size, 1))
    L = cfg.n_layers
    return {"flash_attention": 2 * L, "flash_attention_bwd": L,
            "fused_xent": 2 * n_chunks, "fused_xent_bwd": n_chunks}


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


def run_train_cli(torch, rec, B=32, S=512, n_functions=3000):
    """bert-mlm-120m at full width and depth through
    repro_torch.launch.train.main, over one DataPipeline data dir: (a) 20
    steps with the R3 autotune; (b) the same run with --ckpt-dir and
    --ckpt-every 10, stopped by the fault point after its step-10
    checkpoint (the lr schedule spans --steps, so the run that is
    resumed must be launched with --steps 20); (d) steps 10 to 20 from
    that checkpoint through runner.resume and TrainLoop, the device
    prefetch 4 deep; (c) a fresh main with --resume, steps 10 to 20 at
    the CLI's depth 2.  (c) and (d) must each repeat (a)'s losses bit for
    bit.  Then the module entry point once as a subprocess."""
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
    res = {"batch": B, "seq": S, "n_functions": n_functions, "launches_per_step_want": want}

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

    # (a) the uninterrupted run, workers auto-tuned
    state_a, log_a = counted("a", ["--steps", "20", "--workers", "0"], 20)
    losses_a = res["a"]["losses"]
    if len(losses_a) != 20 or not all(math.isfinite(x) for x in losses_a) \
            or not losses_a[-1] < losses_a[0]:
        fail(f"train_cli a: losses {losses_a}")
    del state_a

    # (b) the same run with checkpoints, stopped after its step-10 checkpoint
    ckpt_argv = ["--steps", "20", "--workers", "2", "--ckpt-dir", str(ck), "--ckpt-every", "10"]
    fault = {"REPRO_FAULT_PHASE": "step", "REPRO_FAULT_STEP": "10", "REPRO_FAULT_MODE": "raise"}
    os.environ.update(fault)
    ops.reset_launch_counts()
    try:
        cli.main(base + ckpt_argv)
        fail("train_cli b: the fault point at step 10 did not stop the run")
    except TransientWorkerError as e:
        log(f"train_cli b: stopped as planned: {e}")
    finally:
        for k in fault:
            os.environ.pop(k)
    torch.cuda.synchronize()
    counts_b = dict(ops.launch_counts)
    res["b"] = {"argv": ckpt_argv, "launches": counts_b,
                "launches_per_step": {k: counts_b.get(k, 0) / 11 for k in want}}
    if res["b"]["launches_per_step"] != {k: float(v) for k, v in want.items()}:
        fail(f"train_cli b: launches {counts_b} over 11 steps, expected {want} a step")
    if ckpt.latest_step(str(ck)) != 10:
        fail(f"train_cli b: newest committed checkpoint {ckpt.latest_step(str(ck))}, not 10")
    shard = Path(ckpt.step_dir(str(ck), 10)) / "shard-00000.npz"
    res["b"]["ckpt_bytes"] = shard.stat().st_size
    with np.load(shard) as z:
        res["b"]["ckpt_opt_step"] = int(z["opt/step"])
    if res["b"]["ckpt_opt_step"] != 10:
        fail(f"train_cli b: ckpt-00000010 holds opt/step {res['b']['ckpt_opt_step']}")

    # (d) the same resume through the library's entry points, with the
    # pipeline's device prefetch 4 deep (the CLI's is 2): steps 11-20 must
    # again be (a)'s, bit for bit.  Runner and pipeline are built as the
    # CLI builds them.
    run = default_run_config(cfg, ShapeConfig("cli", S, B, "train"))
    pipe = DataPipeline.build(str(data), n_functions=n_functions, seq_len=S, batch_size=B,
                              vocab_size=cfg.vocab_size, n_workers=2, device_prefetch=4,
                              work_fn=cli.make_work_fn(cfg))
    try:
        runner = StepRunner(build_model(cfg), run,
                            AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20))
        state_d, start = resume(str(ck), runner, pipeline=pipe, step=10)
        state_d, _ = counted("d", ["resume(step=10)", "device_prefetch=4"], 10,
                             lambda: TrainLoop(runner, log_every=1).run(
                                 pipe, 20, state=state_d, start_step=start))
        if res["d"]["steps"] != list(range(11, 21)) or res["d"]["losses"] != losses_a[10:]:
            fail(f"train_cli d: resumed losses at prefetch depth 4 "
                 f"{list(zip(res['d']['steps'], res['d']['losses']))} "
                 f"!= uninterrupted {losses_a[10:]}")

        # where a step's time goes, on the CLI's f32 path and its batches
        p50 = log_a.telemetry["step_time_p50"]
        res["profile"] = profile_steps(torch, runner, state_d,
                                       [runner.place_batch(pipe.peek_batch(k)) for k in range(3)],
                                       p50)
        del state_d, runner
        res["prefetch_check"] = check_prefetch(torch, pipe)
    finally:
        pipe.close()

    # (c) resumed in a fresh main: steps 11-20 must be (a)'s, bit for bit
    state_c, log_c = counted("c", ckpt_argv + ["--resume", "--keep-last-k", "1"], 10)
    if res["c"]["steps"] != list(range(11, 21)) or res["c"]["losses"] != losses_a[10:]:
        fail(f"train_cli c: resumed losses {list(zip(res['c']['steps'], res['c']['losses']))} "
             f"!= uninterrupted {losses_a[10:]}")
    res["resume_bit_exact"] = True
    del state_c

    # the module entry point, as a user runs it
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *base, "--steps", "3",
                          "--workers", "2"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    res["module_run"] = {"rc": out.returncode, "wall_s": time.perf_counter() - t0,
                         "tail": out.stdout[-1500:], "stderr_tail": out.stderr[-1500:]}
    if out.returncode != 0 or "[done]" not in out.stdout:
        fail(f"train_cli: python -m repro_torch.launch.train exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    shutil.rmtree(ck, ignore_errors=True)

    t_a, t_c = log_a.telemetry, res["c"]["telemetry"]
    tokens = B * S
    res.update(step_time_p50_ms=p50 * 1e3, tokens_per_s=tokens / p50,
               mfu=model_flops(cfg, tokens) / (p50 * DEFAULT_PEAK_FLOPS),
               data_wait_share=t_a["data_wait_s"] / t_a["total_s"],
               data_wait_ms_per_step=t_a["data_wait_s"] / 20 * 1e3,
               autotune={"n_workers": t_a["n_workers"], "device_prefetch": t_a["device_prefetch"]},
               ckpt_host_copy_ms=t_c["ckpt_host_copy_s"] * 1e3,
               ckpt_write_ms=t_c["ckpt_write_s"] * 1e3, ckpt_saves=t_c["ckpt_saves"],
               ckpt_bytes=res["b"]["ckpt_bytes"],
               first_loss=losses_a[0], last_loss=losses_a[-1], launches=res["a"]["launches"])
    log("train_cli: " + json.dumps({k: v for k, v in res.items()
                                    if k not in ("a", "b", "c", "profile", "module_run")}))
    rec["train_cli"] = res


REPO_KERNELS = ("flash_fwd", "dq_wgmma", "dkdv_wgmma", "dq_mma", "dkdv_mma", "dq_f32",
                "dkdv_f32", "delta_kernel", "xent_fwd", "xent_bwd", "paged_partial",
                "paged_wgmma", "paged_combine", "ssd_scan_kernel", "ssd_state_wgmma",
                "ssd_carry", "ssd_out_wgmma")


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
    cores, f32 outside them."""
    return PEAK_F32_FLOPS if q.element_size() == 4 else PEAK_BF16_FLOPS


def flash_bwd_bound(q, k, causal):
    """(bound ms, what bounds it) of a flash backward: five products (S,
    dP, dV, dK, dQ) of 2 D flops per unmasked (query, key) pair and head;
    q, o, do, dq and k, v, dk, dv moved once in the inputs' dtype, the f32
    lse read once."""
    B, S, H, D = q.shape
    pairs = S * (S + 1) / 2 if causal else S * S
    nbytes = q.element_size() * B * S * D * (4 * H + 4 * k.shape[2]) + 4 * B * H * S
    return _bound(10 * B * H * D * pairs, nbytes, _flash_peak(q))


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


def time_flash_bwd(torch, checked, what, q, k, v, do, causal):
    """The backward kernel at one shape against the gate, its bound, the
    plain version's autograd (eager) and SDPA's backward op: ``ms`` and
    ``library_ms`` by CUDA-graph replay, ``library_eager_ms`` SDPA's
    autograd backward by back-to-back eager calls, and the kernel's
    device time split by its device kernels."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    ratio = checked(f"flash_bwd {what}", flash_bwd_reading(torch, q, k, v, do, causal))
    o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    run = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ms, call_ms = time_ms(torch, run)
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        o_plain = ref.flash_attention_ref(qr, kr, vr, causal=causal)
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=q.shape[2] != k.shape[2])
    plain_ms = eager_ms(torch, lambda: torch.autograd.grad(
        o_plain, (qr, kr, vr), do, retain_graph=True))
    lib_eager = eager_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    del o_plain, o_lib
    try:
        lib_ms, lib_call_ms = time_ms(torch, sdpa_bwd(torch, q, k, v, do, causal))
    except RuntimeError as e:       # a torch whose flash op this card or graph refuses
        log(f"time flash_bwd {what}: SDPA's backward op not timed: {e}")
        lib_ms = lib_call_ms = None
    bound = flash_bwd_bound(q, k, causal)
    lib_op = "efficient" if q.dtype == torch.float32 else "flash"
    res = {"shape": list(q.shape) + [k.shape[2]], "dtype": str(q.dtype).split(".")[1],
           "causal": causal, "ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_call_ms": lib_call_ms, "library_eager_ms": lib_eager,
           "bound_ms": bound[0], "bound_by": bound[1], "err_over_limit": ratio,
           "by_kernel": device_ms_by_kernel(torch, run),
           "plain": "autograd backward, eager (CUDA events)",
           "library": f"aten._scaled_dot_product_{lib_op}_attention_backward by CUDA-graph "
                      "replay (K, V repeated to H heads); library_eager_ms: SDPA's "
                      "autograd backward, eager"}
    log(f"time flash_bwd {what}: {res}")
    return res


def flash_bound(q, k, causal, lse):
    """(bound ms, what bounds it) of a flash forward: 4 D flops per
    unmasked (query, key) pair and head, q, k, v read and o (and the f32
    lse) written once in the inputs' dtype."""
    B, S, H, D = q.shape
    pairs = S * (S + 1) / 2 if causal else S * S
    nbytes = q.element_size() * B * S * D * (2 * H + 2 * k.shape[2]) \
        + (4 * B * H * S if lse else 0)
    return _bound(4 * B * H * D * pairs, nbytes, _flash_peak(q))


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
                   **time_train_kernels(torch, checked, gen)}


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
    G 1, N 128, chunk 256), in bf16 (the serve path's dtype) and f32, and
    in bf16 at zamba2-2.7b's (H 80, N 64).  No PyTorch call computes SSD:
    no library yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd

    mamba2, zamba2 = SSD_CASES[0], next(c for c in SSD_CASES if c[2] == 80)
    out = {}
    for key, case, dname, peak in (("bfloat16", mamba2, "bfloat16", PEAK_BF16_FLOPS),
                                   ("float32", mamba2, "float32", PEAK_F32_FLOPS),
                                   ("zamba2_bf16", zamba2, "bfloat16", PEAK_BF16_FLOPS)):
        dtype = getattr(torch, dname)
        x, dt, A, Bm, Cm = _ssd_inputs(torch, case, dtype, gen)
        ratio = checked(f"ssd_scan {key}", ssd_reading(torch, x, dt, A, Bm, Cm, case[6]))
        ms, call_ms = time_ms(torch, lambda: ssd_scan_fwd(x, dt, A, Bm, Cm, case[6]))
        plain_ms, plain_call_ms = time_ms(torch, lambda: ref.ssd_ref(x, dt, A, Bm, Cm, case[6]))
        bound = _bound(*ssd_work(*case[:7], x.element_size()), peak)
        out[key] = {"shape": list(case[:7]), "dtype": dname, "ms": ms, "call_ms": call_ms,
                    "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
                    "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1],
                    "err_over_limit": ratio,
                    "by_kernel": device_ms_by_kernel(
                        torch, lambda: ssd_scan_fwd(x, dt, A, Bm, Cm, case[6]))}
        log(f"time ssd_scan {key}: {out[key]}")
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
                "bound_ms": fwd_b[0], "bound_by": fwd_b[1], "err_over_limit": r_fwd},
        "bwd": time_flash_bwd(torch, checked, what, q, k, v, do, causal)}
    log(f"time flash {what}: {res['fwd']}")
    return res, (q, k, v, do)


def time_train_kernels(torch, checked, gen, T=3904, V=32768):
    """The train phases' kernels at their shapes: flash forward and
    backward at bert-mlm-120m's attention (BERT_ATTN, non-causal) in bf16
    and in f32 (the train_cli phase's dtype, on the f32 bodies), fused_xent
    forward and backward on one loss chunk (32 x 122 rows of 32768 logits)
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
    # the serve shape (starcoder2-3b's attention at S 1024), whose kv heads
    # give the dkdv pass only 16 blocks
    q, do = (torch.randn(1, 1024, 24, 128, generator=gen, device="cuda").to(bf)
             for _ in range(2))
    k, v = (torch.randn(1, 1024, 2, 128, generator=gen, device="cuda").to(bf) for _ in range(2))
    out["flash_bwd_gqa"] = time_flash_bwd(torch, checked, "gqa causal", q, k, v, do, True)
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
    ssm_serve, train and train_cli's run (a)), each counted from 0 just
    before it; the times are those of
    the shape each path runs (flash forward: the serve prefill at S=1024,
    with bert's shape under ``train_shape``; flash backward: bert's shape,
    starcoder2-3b's under ``gqa_causal_shape``; both flash kernels at
    bert's shape in f32, the train_cli path's, under ``train_shape_f32``,
    with its bound at the f32 peak; fused_xent: the f32 logits
    the train path feeds it, with bf16 under ``bf16``; ssd_scan: the bf16
    prefill at S=1024, with f32 under ``f32``)."""
    errs = rec.get("errors", {})
    t = rec.get("time", {})
    paths = {key: rec.get(key, {}).get("launches", {})
             for key in ("serve", "ssm_serve", "train", "train_cli")}
    flash_top = next((x for x in t.get("flash", []) if x["S"] == 1024), {})
    ft, xe = t.get("flash_train", {}), t.get("xent", {})
    ft32 = t.get("flash_train_f32", {})
    ssd = t.get("ssd", {})
    bwd = ft.get("bwd", {})
    extra = {"flash_attention": {"train_shape": ft.get("fwd"),
                                 "train_shape_f32": ft32.get("fwd")},
             "paged_attention": {k: t.get("paged", {}).get(k)
                                 for k in ("call_ms", "host_call_ms", "by_kernel")},
             "flash_attention_bwd": {"call_ms": bwd.get("call_ms"),
                                     "host_call_ms": bwd.get("host_call_ms"),
                                     "library_eager_ms": bwd.get("library_eager_ms"),
                                     "by_kernel": bwd.get("by_kernel"),
                                     "gqa_causal_shape": t.get("flash_bwd_gqa"),
                                     "train_shape_f32": ft32.get("bwd")},
             "fused_xent": {"bf16": xe.get("bfloat16", {}).get("fwd")},
             "fused_xent_bwd": {"bf16": xe.get("bfloat16", {}).get("bwd")},
             "ssd_scan": {"f32": ssd.get("float32"), "zamba2_bf16": ssd.get("zamba2_bf16")}}
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
             "src/repro/kernels/ssd_scan.py:74", ssd.get("bfloat16", {}))):
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
            "paged_ms": rec.get("time", {}).get("paged", {}).get("ms"),
            "ssd_ms": {k: v["ms"] for k, v in rec.get("time", {}).get("ssd", {}).items()}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--against", action="append", default=[], metavar="NAME=SOURCE",
                    help="also run phases serve, ssm_serve, train and time with SOURCE's "
                         "build of the kernel its file name names")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        fail(f"unknown phase in {phases}; phases are {PHASES}")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 phases in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    rec = {"gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    t_all = time.perf_counter()

    from repro_torch.kernels import _build

    against = parse_against(args.against)
    fault_builds = start_fault_builds() if "faults" in phases else None
    against_builds = start_against_builds(against)
    t0 = time.perf_counter()
    _build.build_all()
    rec["build_s"] = time.perf_counter() - t0
    log(f"build: {rec['build_s']:.1f}s")
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
             "train": run_train, "train_cli": run_train_cli, "time": time_kernels}
    for ph in PHASES[1:]:
        if ph in phases:
            t0 = time.perf_counter()
            if against_libs and ph in AGAINST_PHASES:
                run_against(torch, rec, ph, steps[ph], against_libs)
            else:
                steps[ph](torch, rec)
            log(f"phase {ph}: {time.perf_counter() - t0:.1f}s")
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

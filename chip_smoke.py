#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,train_path,train

Phases (any failure exits non-zero before the last line):
  build       build the CUDA kernels from src/repro_torch/kernels/csrc/
  kernels     hold each kernel (forward and backward) against its plain
              PyTorch version (backward: the plain version's autograd) on
              the card, f32 and bf16, at the stated tolerances, up to the
              decode tick's and the training step's shapes
  faults      planted faults: builds copies of the kernels with one known
              bug each and checks that the kernel gate fails them
  path        starcoder2-3b at full width, depth cut to 2 layers, f32: the
              paged engine on cuda and on cpu (plain versions) must agree on
              prefill and decode logits and give the same greedy tokens
  serve       starcoder2-3b at full width and depth, bf16: 16 requests
              through repro_torch.launch.serve's engine; every prefill and
              decode tick must have gone through the kernels (launch counts)
  train_path  bert-mlm-120m at full width, depth cut to 2 layers, f32: the
              same masked batches and initial parameters on cuda and on cpu
              must agree on the loss, every gradient leaf and 5 steps
  train       bert-mlm-120m at full width and depth, f32 parameters and
              bf16 activations, batch 32 x 512: 20 steps through
              repro_torch.train.trainer.train; the loss must fall and every
              attention and loss chunk, forward and backward, must have
              gone through the kernels (launch counts per step)
  time        each kernel at its path's shapes against its plain version,
              its bound and a PyTorch call computing the same function
              (SDPA, F.cross_entropy) as a yardstick: device time per call
              (CUDA-graph replay) and time per back-to-back call

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
PHASES = ("build", "kernels", "faults", "path", "serve", "train_path", "train", "time")

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
]

PAGED_CASES = [  # (B, H, Hkv, D, P, NP, maxp, window, softcap, (pos lo, hi))
    (8, 24, 2, 128, 16, 160, 16, None, 0.0, (0, 255)),     # rep 12, short tables
    (8, 24, 2, 128, 16, 160, 16, 100, 0.0, (0, 255)),      # window
    (8, 24, 2, 128, 16, 160, 16, None, 30.0, (0, 255)),    # softcap
    (4, 8, 2, 64, 8, 64, 12, None, 0.0, (0, 95)),          # rep 4, D 64, page 8
    # the serve phase's decode tick: 128-page tables, prompts of 65-1024
    # plus 32 new tokens, so up to 9 live 8-page splits for the combine
    (8, 24, 2, 128, 16, 512, 128, None, 0.0, (65, 1055)),
    (8, 24, 2, 128, 16, 512, 128, 300, 0.0, (65, 1055)),   # window: splits past 0
]


# the backward kernel: (B, S, H, Hkv, D, causal); no window or softcap yet
FLASH_BWD_CASES = [
    (2, 256, 4, 4, 64, True),       # rep 1, causal
    (1, 300, 8, 2, 128, True),      # rep 4, D 128, ragged S
    (2, 200, 12, 1, 64, False),     # rep 12, non-causal, ragged
    (1, 77, 6, 2, 64, False),       # one ragged tile and a half
    (8, 512, 12, 12, 64, False),    # bert-mlm-120m's attention
]

XENT_CASES = [  # (T, V)
    (3904, 32768),   # one loss chunk of the train phase: 32 x 122 rows
    (37, 1000),      # a ragged last tile
    (5, 1001),       # V odd: the scalar loads
    (300, 4099),     # one column past a tile
    (64, 50),        # less than one tile
]


def _flash_inputs(torch, case, dtype, gen):
    B, S, H, Hkv, D, *_ = case
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return mk(B, S, H, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)


def _paged_inputs(torch, case, dtype, gen):
    """Fragmented tables; positions in the case's range, the first two
    active slots at its ends; up to two allocated pages past each
    position (as the engine allocates for max_new) and trash page 0 past
    each allocation; two inactive slots (all-zero tables, stale
    positions; one past the table)."""
    B, H, Hkv, D, P, NP, maxp, _, _, (lo, hi) = case
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    q, kp, vp = mk(B, H, D), mk(NP, P, Hkv, D), mk(NP, P, Hkv, D)
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
    pos[B - 1] = maxp * P + 7             # inactive: stale, past the table
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
            if case[0] == 8 and want("flash_attention"):    # bert's forward shape too
                out.append(("flash_attention", case, *flash_reading(torch, q, k, v, causal)))
            out.append(("flash_attention_bwd", case,
                        *flash_bwd_reading(torch, q, k, v, do, causal)))
    if want("fused_xent", "fused_xent_bwd"):
        for case in XENT_CASES:
            fwd, bwd = xent_readings(torch, *_xent_inputs(torch, case, dtype, gen))
            out.append(("fused_xent", case, *fwd))
            out.append(("fused_xent_bwd", case, *bwd))
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
     "const float pw = key < S ? expf(",
     "const float pw = key < S && !(k0 == 0 && kt_hi > 8) ? expf("),
    ("paged_attention", ("paged_attention",),
     "combine merges at most 8 splits (the first 1024 keys)",
     "s1 = j_hi / p.pps;", "s1 = min(j_hi / p.pps, s0 + 7);"),
    ("fused_xent", ("fused_xent", "fused_xent_bwd"), "forward skips the last vocab tile",
     "for (int c0 = 0; c0 < V; c0 += TILE) {  // vocab tiles, in order",
     "for (int c0 = 0; c0 + TILE < V; c0 += TILE) {  // vocab tiles, in order"),
    ("flash_attention_bwd", ("flash_attention_bwd",),
     "dq drops the contribution of k tile 0 when there are more",
     "for (int kt = 0; kt < kt_hi; ++kt) {  // every k tile adds to dq",
     "for (int kt = kt_hi > 1 ? 1 : 0; kt < kt_hi; ++kt) {  // every k tile adds to dq"),
]
KERNELS = ("flash_attention", "flash_attention_bwd", "paged_attention", "fused_xent",
           "fused_xent_bwd")


def start_fault_builds():
    """Write the faulty sources under build/kernels/faults/ and start one
    nvcc for each; returns {kernel: (process, library path)}."""
    from repro_torch.kernels import _build

    d = _build.BUILD_DIR / "faults"
    d.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, _, _, old, new in FAULTS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        if text.count(old) != 1:
            fail(f"faults: {name}.cu does not hold {old!r} once; update FAULTS")
        src, lib = d / f"{name}.cu", d / f"lib{name}.so"
        src.write_text(text.replace(old, new))
        procs[name] = (subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    return procs


def check_faults(torch, rec, procs):
    import ctypes

    from repro_torch.kernels import _build

    res = []
    for name, kernels, bug, _, _ in FAULTS:
        proc, lib = procs[name]
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


def check_path(torch, rec):
    import copy

    from repro_torch.configs import default_run_config, get_config
    from repro_torch.configs.base import LayerSpec, ShapeConfig, uniform_schedule
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import random_prompts, serve
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import PagedServeEngine

    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              schedule=uniform_schedule(2, LayerSpec()))
    run = default_run_config(cfg, ShapeConfig("serve", 0, 0, "decode"))
    model_cpu = build_model(cfg, seed=0, device="cpu")
    model_gpu = copy.deepcopy(model_cpu).to("cuda")   # the same weights
    # a 300-token prompt: 20 pages, three of the paged kernel's 8-page splits
    eng_cpu, eng_gpu = (PagedServeEngine(m, run, page=16, n_pages=128, max_slots=4,
                                         max_pages=32) for m in (model_cpu, model_gpu))
    prompts = random_prompts(2, [300, 37], cfg.vocab_size, seed=1)
    logs, outs = {}, {}
    for name, eng in (("cpu", eng_cpu), ("cuda", eng_gpu)):
        logs[name] = []
        _tap(eng, logs[name])
        ops.reset_launch_counts()
        outs[name] = serve(eng, prompts, max_new=9)
        counts = dict(ops.launch_counts)
        log(f"path {name}: launches {counts}, ticks {eng.decode_ticks}")
        if name == "cuda" and (counts.get("flash_attention") != 2 * len(prompts)
                               or counts.get("paged_attention") != 2 * eng.decode_ticks):
            fail(f"path: the cuda run did not go through the kernels: {counts}")
        if name == "cpu" and counts:
            fail(f"path: the cpu run launched kernels: {counts}")
    if outs["cpu"] != outs["cuda"]:
        fail(f"path: greedy tokens differ: cpu {outs['cpu']} cuda {outs['cuda']}")
    worst = 0.0
    for (kind, a), (_, b) in zip(logs["cpu"], logs["cuda"], strict=True):
        rel = ((a - b).abs().max() / a.abs().max()).item()
        worst = max(worst, rel)
        if not torch.isfinite(b).all() or not rel <= PATH_REL_TOL:
            fail(f"path: {kind} logits differ, relative error {rel}")
    log(f"path: {len(logs['cpu'])} logit sets agree, max relative error "
        f"{worst:.3e} (tol {PATH_REL_TOL}); tokens equal")
    rec["path"] = {"max_rel_err": worst, "logit_sets": len(logs["cpu"]),
                   "tokens": outs["cuda"]}


def run_serve(torch, rec, seed=0):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, random_prompts, serve

    cfg = get_config("starcoder2-3b")
    n_req, max_new = 16, 32
    t0 = time.perf_counter()
    eng = build_engine(cfg, device="cuda", dtype="bfloat16", seed=seed, page=16,
                       n_pages=1024, max_slots=8, max_pages=128)
    torch.cuda.synchronize()
    log(f"serve: model + pools built in {time.perf_counter() - t0:.1f}s, "
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
    log(f"serve: launches {counts}, decode ticks {ticks}")
    if len(out) != n_req or any(len(t) != max_new for t in out.values()):
        fail(f"serve: {len(out)} of {n_req} requests finished")
    if any(not 0 <= t < cfg.vocab_size for toks in out.values() for t in toks):
        fail("serve: a token id outside the vocabulary")
    if counts.get("flash_attention") != n_layers * n_req:
        fail(f"serve: flash launches {counts.get('flash_attention')} != {n_layers} x {n_req}")
    if counts.get("paged_attention") != n_layers * ticks:
        fail(f"serve: paged launches {counts.get('paged_attention')} != {n_layers} x {ticks}")
    res = {"requests": n_req, "prompt_lens": lens, "max_new": max_new,
           "seconds": dt, "tokens_per_s": n_req * max_new / dt,
           "ttft_p50_ms": float(np.median(eng.samples["ttft_ms"])),
           "decode_tick_p50_ms": float(np.median(eng.samples["decode_tick_ms"])),
           "decode_ticks": ticks, "launches": counts}
    log(f"serve: {json.dumps({k: v for k, v in res.items() if k != 'prompt_lens'})}")
    rec["serve"] = res
    rec["decode_profile"] = profile_ticks(torch, eng, cfg, res["decode_tick_p50_ms"])
    del eng
    torch.cuda.empty_cache()


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
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / n_ticks / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    res = {"tick_wall_ms": wall, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall if busy else None,
           "idle_share_vs_p50": 1 - busy / tick_p50_ms if busy else None,
           "kernel_launches_per_tick": sum(e.count for e in kern) / n_ticks,
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
    n_chunks = -(-S // c)
    L = cfg.n_layers
    # per step: each layer's attention forward, again under remat, and its
    # backward; each loss chunk's nll forward, again under its checkpoint,
    # and its backward
    want = {"flash_attention": 2 * L, "flash_attention_bwd": L,
            "fused_xent": 2 * n_chunks, "fused_xent_bwd": n_chunks}
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


REPO_KERNELS = ("flash_fwd", "dq_mma", "dkdv_mma", "dq_f32", "dkdv_f32", "delta_kernel",
                "xent_fwd", "xent_bwd", "paged_partial", "paged_combine")


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
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / n / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    by_class = {}
    for e in kern:
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / n / 1e3
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


def time_kernels(torch, rec):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention_fwd

    def checked(what, reading):   # the timed inputs are held to the kernel gate first
        err, ratio = reading
        log(f"time {what}: max_abs_err {err:.3e}, error/limit {ratio:.3f}")
        if not ratio <= 1.0:
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
        flops = 4 * H * D * S * (S + 1) / 2          # unmasked causal pairs
        nbytes = 2 * (2 * S * H * D + 2 * S * Hkv * D)
        ratio = checked(f"flash S={S}", flash_reading(torch, q, k, v, True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms, call_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True))
        plain_ms, plain_call_ms = time_ms(
            torch, lambda: ref.flash_attention_ref(q, k, v, causal=True))
        lib_ms, lib_call_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound_s = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
        flash.append({
            "S": S, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_s * 1e3,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES
            else "bytes",
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
    ms, call_ms = time_ms(
        torch, lambda: paged_attention_fwd(q, kp, vp, tables[next(it) % R], pos))
    plain_ms, plain_call_ms = time_ms(torch, lambda: ref.paged_attention_ref(
        q, kp, vp, tables[next(it) % R], pos))
    paged = {
        "live_tokens": live, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
        "call_ms": call_ms, "plain_call_ms": plain_call_ms, "err_over_limit": ratio}
    log(f"time paged: {paged}")
    rec["time"] = {"flash": flash, "paged": paged, **time_train_kernels(torch, checked, gen)}


def time_train_kernels(torch, checked, gen, B=32, S=512, H=12, D=64, T=3904, V=32768):
    """The train phase's kernels at its shapes: flash forward and backward
    at bert-mlm-120m's attention (bf16, non-causal), fused_xent forward
    and backward on one loss chunk (32 x 122 rows of 32768 logits) in
    f32, the train path's dtype, and in bf16.  Library yardsticks: SDPA
    and its autograd backward, F.cross_entropy and its autograd
    backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.fused_xent import fused_xent_bwd, fused_xent_fwd

    out = {}
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(bf)
                   for _ in range(4))
    r_fwd = checked("flash train shape", flash_reading(torch, q, k, v, False))
    r_bwd = checked("flash_bwd train shape", flash_bwd_reading(torch, q, k, v, do, False))
    o, lse = flash_attention_fwd(q, k, v, causal=False, return_lse=True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
    fwd_ms, fwd_call = time_ms(
        torch, lambda: flash_attention_fwd(q, k, v, causal=False, return_lse=True))
    fwd_nolse, _ = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=False))
    fwd_plain, _ = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=False))
    fwd_lib, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bwd_ms, bwd_call = time_ms(
        torch, lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=False))
    with torch.enable_grad():
        o_plain = ref.flash_attention_ref(qr, kr, vr, causal=False)
        o_lib = F.scaled_dot_product_attention(qt, kt, vt)
    bwd_plain = eager_ms(torch, lambda: torch.autograd.grad(
        o_plain, (qr, kr, vr), do, retain_graph=True))
    bwd_lib = eager_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    io = B * S * H * D * 2
    fwd_b = _bound(4 * B * H * S * S * D, 4 * io + B * H * S * 4, PEAK_BF16_FLOPS)
    bwd_b = _bound(10 * B * H * S * S * D, 8 * io + B * H * S * 4, PEAK_BF16_FLOPS)
    out["flash_train"] = {
        "shape": [B, S, H, D], "dtype": "bfloat16", "causal": False,
        "fwd": {"ms": fwd_ms, "ms_without_lse": fwd_nolse, "call_ms": fwd_call,
                "plain_ms": fwd_plain, "library_ms": fwd_lib,
                "bound_ms": fwd_b[0], "bound_by": fwd_b[1], "err_over_limit": r_fwd},
        "bwd": {"ms": bwd_ms, "call_ms": bwd_call, "plain_ms": bwd_plain, "library_ms": bwd_lib,
                "bound_ms": bwd_b[0], "bound_by": bwd_b[1], "err_over_limit": r_bwd,
                "plain_and_library": "autograd backward, eager (CUDA events)"}}
    log(f"time flash train shape: {out['flash_train']}")
    del o_plain, o_lib, qt, kt, vt, qr, kr, vr, o, lse
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
    """One record per kernel.  ``launches``: the main paths' runs (serve
    and train), each counted from 0 just before it; the times are those of
    the shape each path runs (flash forward: the serve prefill at S=1024,
    with bert's shape under ``train_shape``; fused_xent: the f32 logits
    the train path feeds it, with bf16 under ``bf16``)."""
    errs = rec.get("errors", {})
    t = rec.get("time", {})
    paths = {"serve": rec.get("serve", {}).get("launches", {}),
             "train": rec.get("train", {}).get("launches", {})}
    flash_top = next((x for x in t.get("flash", []) if x["S"] == 1024), {})
    ft, xe = t.get("flash_train", {}), t.get("xent", {})
    extra = {"flash_attention": {"train_shape": ft.get("fwd")},
             "fused_xent": {"bf16": xe.get("bfloat16", {}).get("fwd")},
             "fused_xent_bwd": {"bf16": xe.get("bfloat16", {}).get("bwd")}}
    csrc = "src/repro_torch/kernels/csrc/"
    out = []
    for name, src, replaces, timing in (
            ("flash_attention", csrc + "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:85", flash_top),
            ("flash_attention_bwd", csrc + "flash_attention_bwd.cu",
             "src/repro/kernels/ops.py:44", ft.get("bwd", {})),
            ("paged_attention", csrc + "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:91", t.get("paged", {})),
            ("fused_xent", csrc + "fused_xent.cu",
             "src/repro/kernels/fused_xent.py:52", xe.get("float32", {}).get("fwd", {})),
            ("fused_xent_bwd", csrc + "fused_xent.cu",
             "src/repro/kernels/ops.py:111", xe.get("float32", {}).get("bwd", {}))):
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
    sv, prof = rec.get("serve", {}), rec.get("decode_profile", {})
    keys = ("tokens_per_s", "ttft_p50_ms", "decode_tick_p50_ms", "decode_ticks")
    tr, tprof = rec.get("train", {}), rec.get("train", {}).get("profile", {})
    tkeys = ("step_time_p50_ms", "tokens_per_s", "mfu", "first_loss", "last_loss",
             "launches_per_step")
    return {"build_s": rec.get("build_s"), "seconds": rec.get("seconds"),
            "serve": {k: sv.get(k) for k in keys},
            "tick_device_busy_ms": prof.get("device_busy_ms"),
            "tick_launches": prof.get("kernel_launches_per_tick"),
            "train": {k: tr.get(k) for k in tkeys},
            "train_step_device_busy_ms": tprof.get("device_busy_ms"),
            "train_step_launches": tprof.get("kernel_launches_per_step"),
            "path_max_rel_err": rec.get("path", {}).get("max_rel_err"),
            "train_path_rel_err": rec.get("train_path", {}).get("rel_err"),
            "faults_max_ratio": {f["kernel"]: f["max_ratio"] for f in rec.get("faults", [])},
            "flash_ms_by_S": {x["S"]: x["ms"] for x in rec.get("time", {}).get("flash", [])}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
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

    fault_builds = start_fault_builds() if "faults" in phases else None
    t0 = time.perf_counter()
    _build.build_all()
    rec["build_s"] = time.perf_counter() - t0
    log(f"build: {rec['build_s']:.1f}s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                log(f"ptxas {name}: {line.strip()}")
    rec["build_log"] = _build.build_log
    steps = {"kernels": check_kernels,
             "faults": lambda torch, rec: check_faults(torch, rec, fault_builds),
             "path": check_path, "serve": run_serve, "train_path": check_train_path,
             "train": run_train, "time": time_kernels}
    for ph in PHASES[1:]:
        if ph in phases:
            t0 = time.perf_counter()
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

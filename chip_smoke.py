#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernels

Phases (any failure exits non-zero before the last line):
  build    build the CUDA kernels from src/repro_torch/kernels/csrc/
  kernels  hold each kernel against its plain PyTorch version on the card,
           f32 and bf16, at the stated tolerances, up to the decode tick's
           shape (128-page tables, ~1000 live tokens per slot)
  faults   planted faults: builds copies of the kernels with one known bug
           each and checks that the kernel gate fails them
  path     starcoder2-3b at full width, depth cut to 2 layers, f32: the
           paged engine on cuda and on cpu (plain versions) must agree on
           prefill and decode logits and give the same greedy tokens
  serve    starcoder2-3b at full width and depth, bf16: 16 requests through
           repro_torch.launch.serve's engine; every prefill and decode
           tick must have gone through the kernels (launch counts)
  time     each kernel at this slice's shapes against its plain version,
           its bound and (flash) torch's SDPA as a yardstick: device time
           per call (CUDA-graph replay) and time per back-to-back call

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
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
PHASES = ("build", "kernels", "faults", "path", "serve", "time")

# H100 SXM peaks (NVIDIA data sheet, dense): the bounds below use them
PEAK_BF16_FLOPS = 989e12
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


def kernel_readings(torch, dname):
    """(kernel, case, max abs error, error / limit) for every case, on
    inputs drawn from one seed."""
    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for case in FLASH_CASES:
        causal, window, cap = case[5:]
        out.append(("flash_attention", case, *flash_reading(
            torch, *_flash_inputs(torch, case, dtype, gen), causal, window, cap)))
    for case in PAGED_CASES:
        window, cap = case[7:9]
        out.append(("paged_attention", case, *paged_reading(
            torch, *_paged_inputs(torch, case, dtype, gen), window, cap)))
    return out


def check_kernels(torch, rec):
    errs = {"flash_attention": {}, "paged_attention": {}}
    for dname in ("float32", "bfloat16"):
        for name, case, err, ratio in kernel_readings(torch, dname):
            log(f"{name} {dname} {case}: max_abs_err {err:.3e}, error/limit {ratio:.3f}")
            if not ratio <= 1.0:
                fail(f"{name} {dname} {case}: error {err} is {ratio:.3f} x its limit")
            e = errs[name].setdefault(dname, {"max_abs_err": 0.0, "max_ratio": 0.0})
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["max_ratio"] = max(e["max_ratio"], ratio)
    rec["errors"] = errs


# planted faults: (kernel, the bug, source text, its replacement); the
# gate must fail each on at least one case
FAULTS = [
    ("flash_attention", "bf16 body drops keys 0-63 of every row that sees more than 512 keys",
     "const float pw = key < S ? expf(",
     "const float pw = key < S && !(k0 == 0 && kt_hi > 8) ? expf("),
    ("paged_attention", "combine merges at most 8 splits (the first 1024 keys)",
     "s1 = j_hi / p.pps;", "s1 = min(j_hi / p.pps, s0 + 7);"),
]


def start_fault_builds():
    """Write the faulty sources under build/kernels/faults/ and start one
    nvcc for each; returns {kernel: (process, library path)}."""
    from repro_torch.kernels import _build

    d = _build.BUILD_DIR / "faults"
    d.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, _, old, new in FAULTS:
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
    import importlib

    from repro_torch.kernels import _build

    res = []
    for name, bug, _, _ in FAULTS:
        proc, lib = procs[name]
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"faults: the faulty {name} did not build:\n{out}")
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        good = _build.load(name)
        _build._libs[name], mod._fn = ctypes.CDLL(str(lib)), None
        try:
            readings = [r for r in kernel_readings(torch, "bfloat16") if r[0] == name]
        finally:
            _build._libs[name], mod._fn = good, None
        caught = [(case, err, ratio) for _, case, err, ratio in readings if ratio > 1.0]
        old = max(err for _, _, err, _ in readings)
        log(f"faults: {name} with '{bug}': gate fails {len(caught)} of {len(readings)} "
            f"cases {[c[0] for c in caught]}, max error/limit "
            f"{max(r[3] for r in readings):.2f}; max abs error {old:.3e} against the "
            f"former flat {OLD_BF16_TOL}")
        if not caught:
            fail(f"faults: the kernel gate passed {name} with the planted bug '{bug}'")
        res.append({"kernel": name, "bug": bug, "cases_failed": len(caught),
                    "cases": len(readings), "failed": [list(map(str, c)) for c in caught],
                    "max_ratio": max(r[3] for r in readings), "max_abs_err": old,
                    "former_flat_gate_fails": old > OLD_BF16_TOL})
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
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return dev, a.elapsed_time(b) / iters


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
    rec["time"] = {"flash": flash, "paged": paged}


def kernel_records(rec):
    errs = rec.get("errors", {})
    t = rec.get("time", {})
    launches = rec.get("serve", {}).get("launches", {})
    flash_top = next((x for x in t.get("flash", []) if x["S"] == 1024), {})
    out = []
    for name, src, replaces, timing in (
            ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:85", flash_top),
            ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:91", t.get("paged", {}))):
        e = errs.get(name, {})
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(name),
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
    return {"build_s": rec.get("build_s"), "seconds": rec.get("seconds"),
            "serve": {k: sv.get(k) for k in keys},
            "tick_device_busy_ms": prof.get("device_busy_ms"),
            "tick_launches": prof.get("kernel_launches_per_tick"),
            "path_max_rel_err": rec.get("path", {}).get("max_rel_err"),
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
             "path": check_path, "serve": run_serve, "time": time_kernels}
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

"""The port's CUDA kernels and its engine on the card (marker ``cuda``).

Without a card every test here skips; on the card run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which a machine
with the card need not have.)

The kernels are held against their plain versions on the same inputs
(f32 at the JAX kernel tests' 2e-5 for attention, 1e-4 and 1e-5 for the
cross-entropy forward and backward, 1e-4 for the SSD scan), the backward
kernels against the plain version's autograd, the engine on ``cuda``
against the same engine on ``cpu`` (same greedy tokens, for starcoder2
and mamba2) and the train step likewise (losses within 1e-4)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import default_run_config, get_config, reduced
from repro_torch.configs.base import LayerSpec, ShapeConfig, uniform_schedule
from repro_torch.kernels import ops, ref
from repro_torch.models.model import build_model
from repro_torch.serve.engine import PagedServeEngine

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-5, rtol=2e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("S,rep,causal,window,softcap", [
    (128, 1, True, None, 0.0), (77, 3, True, 20, 0.0),
    (200, 12, False, None, 30.0), (513, 4, True, None, 0.0)])
def test_flash_kernel_matches_plain(cuda, S, rep, causal, window, softcap):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(2, S, 2 * rep, 64, generator=g, device=cuda)
    k, v = (torch.randn(2, S, 2, 64, generator=g, device=cuda) for _ in range(2))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.testing.assert_close(got, want, **TOL)
    assert ops.launch_counts["flash_attention"] == 1


def _plain_lse(q, k, causal, window, softcap):
    """Each row's log-sum-exp of the masked f32 scores, (B, H, S)."""
    B, S, H, D = q.shape
    kr = k.repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * D**-0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    i = torch.arange(S, device=q.device)
    ok = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        ok &= i[None, :] <= i[:, None]
    if window is not None:
        ok &= i[None, :] > i[:, None] - window
    return s.masked_fill(~ok, ref.NEG_INF).logsumexp(-1)


# (rep, causal, window, softcap, lse): GQA 1 / 4 / 12, a window of 100 and
# a softcap of 30, with and without the lse output
BF16_FLASH_VARIANTS = [(1, True, None, 0.0, True), (4, False, None, 0.0, False),
                       (12, True, 100, 0.0, True), (4, True, None, 30.0, False),
                       (12, False, 100, 30.0, True)]


@pytest.mark.parametrize("variant", BF16_FLASH_VARIANTS)
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 127, 128, 129, 255, 513, 1024])
def test_flash_bf16_kernel_tile_edges(cuda, S, D, variant):
    """The bf16 (wgmma) body at the edges of its tiles (128 q rows a
    block; 64 or 128 keys a tile) against the plain version on the same
    bf16 values in f32, per element: u (|want| + want_abs) + 1e-5 with
    u = 2^-8, want_abs the plain version with |v| (rounding the output and
    P to bf16 costs at most u |want| and u P|v| / l), as chip_smoke.py's
    gate.  The lse within 1e-4: f32 sums of up to 1024 exponentials in
    another order, about 1024 x 2^-24 relative to l."""
    rep, causal, window, softcap, want_lse = variant
    g = torch.Generator(device=cuda).manual_seed(S * D + rep)
    q = torch.randn(2, S, 2 * rep, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, S, 2, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    ops.reset_launch_counts()
    got = flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap,
                              return_lse=want_lse)
    got, lse = got if want_lse else (got, None)
    qf, kf, vf = q.float(), k.float(), v.float()
    opts = dict(causal=causal, window=window, softcap=softcap)
    want = ref.flash_attention_ref(qf, kf, vf, **opts)
    want_abs = ref.flash_attention_ref(qf, kf, vf.abs(), **opts)
    err = (got.float() - want).abs()
    lim = 2.0**-8 * (want.abs() + want_abs) + 1e-5
    assert got.dtype == torch.bfloat16 and (err <= lim).all(), (err / lim).max()
    if want_lse:
        torch.testing.assert_close(lse, _plain_lse(qf, kf, causal, window, softcap),
                                   atol=1e-4, rtol=0)
    assert ops.launch_counts["flash_attention"] == 1


@pytest.mark.parametrize("rep,window", [(12, None), (2, 9)])
def test_paged_kernel_matches_plain(cuda, rep, window):
    g = torch.Generator(device=cuda).manual_seed(rep)
    B, P, NP, maxp = 5, 8, 40, 6
    q = torch.randn(B, 2 * rep, 128, generator=g, device=cuda)
    kp, vp = (torch.randn(NP, P, 2, 128, generator=g, device=cuda) for _ in range(2))
    perm = np.random.RandomState(rep).permutation(np.arange(1, NP))
    tables = torch.zeros(B, maxp, dtype=torch.int32)
    tables[:3] = torch.from_numpy(perm[:3 * maxp].reshape(3, maxp).astype(np.int32))
    # slots 3, 4 inactive with stale positions, 4 past the table (but with
    # live keys inside the window: a row with none is undefined in both)
    pos = torch.tensor([47, 8, 0, 5, maxp * P + 2], dtype=torch.int32)
    args = (q, kp, vp, tables.to(cuda), pos.to(cuda))
    ops.reset_launch_counts()
    got = ops.paged_attention(*args, window=window)
    torch.testing.assert_close(got, ref.paged_attention_ref(*args, window=window), **TOL)
    assert ops.launch_counts["paged_attention"] == 1


@pytest.mark.parametrize("case", _chip_smoke().PAGED_CASES, ids=str)
def test_paged_bf16_kernel_near_plain(cuda, case):
    """Every gate case of chip_smoke.py in bf16, where the wrapper's shape
    rule sends all of them to the wgmma body: within u (|want| + want_abs)
    + 1e-5 per element of ``ref.paged_attention_ref`` on the same bf16
    values in f32 (u = 2^-8: the output's rounding and P's before P V),
    one launch a call."""
    from repro_torch.kernels.paged_attention import wgmma_body

    cs = _chip_smoke()
    B, H, Hkv, D, P, *_ = case
    assert wgmma_body(torch.bfloat16, D, P, H // Hkv)
    gen = torch.Generator(device=cuda).manual_seed(B * H + D + P)
    inputs = cs._paged_inputs(torch, case, torch.bfloat16, gen)
    ops.reset_launch_counts()
    err, ratio = cs.paged_reading(torch, *inputs, case[7], case[8])
    assert ratio <= 1.0, (err, ratio)
    assert ops.launch_counts["paged_attention"] == 1


def test_engine_cuda_matches_cpu(cuda):
    cfg = dataclasses.replace(reduced(get_config("starcoder2-3b")),
                              schedule=uniform_schedule(2, LayerSpec()))
    run = default_run_config(cfg, ShapeConfig("s", 16, 2, "decode"))
    prompts = [np.random.RandomState(i).randint(4, cfg.vocab_size, n).tolist()
               for i, n in enumerate((70, 13, 100))]
    outs = []
    for device in ("cpu", cuda):
        eng = PagedServeEngine(build_model(cfg, device="cpu").to(device), run,
                               page=8, n_pages=64, max_slots=4)
        ops.reset_launch_counts()
        rids = [eng.submit(p, 5) for p in prompts]
        got = eng.serve()
        outs.append([got[r] for r in rids])
    assert outs[0] == outs[1]
    assert ops.launch_counts["flash_attention"] == 2 * len(prompts)


# ---------------------------------------------------------------------------
# training slice: fused_xent forward / backward, flash backward, train step
# ---------------------------------------------------------------------------

XENT_TOL = dict(atol=1e-4, rtol=1e-4)    # the JAX fused_xent tests' bar
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


# V of several 4096-column tiles, a ragged last tile, and V odd (scalar loads)
@pytest.mark.parametrize("T,V", [(64, 32768), (37, 1000), (5, 1001), (300, 4099)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_kernels_match_plain(cuda, T, V, dtype):
    g = torch.Generator(device=cuda).manual_seed(T + V)
    logits = (3 * torch.randn(T, V, generator=g, device=cuda)).to(dtype)
    labels = torch.randint(0, V, (T,), generator=g, device=cuda)
    labels[-1] = V - 1
    gn = torch.randn(T, generator=g, device=cuda)
    ops.reset_launch_counts()
    x = logits.clone().requires_grad_(True)
    nll = ops.xent(x, labels)
    nll.backward(gn)
    want = ref.xent_ref(logits, labels)
    torch.testing.assert_close(nll, want, **XENT_TOL)
    xr = logits.float().requires_grad_(True)
    ref.xent_ref(xr, labels).backward(gn)
    if dtype == torch.float32:
        torch.testing.assert_close(x.grad, xr.grad, **GRAD_TOL)
    else:   # one bf16 rounding of the f32 result: 2^-8 of each element
        err = (x.grad.float() - xr.grad).abs()
        assert (err <= 2.0**-8 * xr.grad.abs() * 1.01 + 1e-12).all(), err.max()
    assert ops.launch_counts["fused_xent"] == 1
    assert ops.launch_counts["fused_xent_bwd"] == 1


@pytest.mark.parametrize("S,rep,causal,D", [
    (128, 1, False, 64), (77, 3, True, 64), (200, 2, False, 128), (513, 4, True, 64)])
def test_flash_bwd_kernel_matches_plain(cuda, S, rep, causal, D):
    g = torch.Generator(device=cuda).manual_seed(S + rep)
    q = torch.randn(2, S, 2 * rep, D, generator=g, device=cuda)
    k, v = (torch.randn(2, S, 2, D, generator=g, device=cuda) for _ in range(2))
    w = torch.randn(2, S, 2 * rep, D, generator=g, device=cuda)
    ops.reset_launch_counts()
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (ops.flash_attention(*got, causal) * w).sum().backward()
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (ref.flash_attention_ref(*want, causal=causal) * w).sum().backward()
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a.grad, b.grad, **TOL, msg=f"d{name}")
    assert ops.launch_counts["flash_attention"] == 1
    assert ops.launch_counts["flash_attention_bwd"] == 1


@pytest.mark.parametrize("S,rep,causal,D", [(512, 1, False, 64), (300, 4, True, 128)])
def test_flash_bwd_bf16_kernel_near_plain(cuda, S, rep, causal, D):
    """The tensor-core body against the f32 plain gradients; bf16 rounds
    P, dS and the outputs, so 2e-2 of each gradient's largest entry.
    ``chip_smoke.py`` holds it to a per-element limit."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q = torch.randn(2, S, 2 * rep, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, S, 2, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    w = torch.randn(2, S, 2 * rep, D, generator=g, device=cuda).bfloat16()
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (ops.flash_attention(*got, causal) * w).float().sum().backward()
    want = [t.float().requires_grad_(True) for t in (q, k, v)]
    (ref.flash_attention_ref(*want, causal=causal) * w.float()).sum().backward()
    for a, b in zip(got, want):
        assert (a.grad.float() - b.grad).abs().max() <= 2e-2 * b.grad.abs().max()


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [63, 64, 65, 127, 129, 511, 513])
def test_flash_bwd_bf16_kernel_tile_edges(cuda, S, D, causal, rep):
    """The bf16 (wgmma) backward at the edges of its tiles (64-row q and
    key tiles, 128 rows or keys a block) against the plain version's
    autograd on the same bf16 values in f32, per element under
    chip_smoke.py's limit u (|want| + want_abs) + 1e-5, u = 2^-8, want_abs
    the bound on the kernel's bf16 roundings of P, dS and the forward's O
    (``flash_bwd_reading``)."""
    g = torch.Generator(device=cuda).manual_seed(S * D + rep + causal)
    q, do = (torch.randn(2, S, 2 * rep, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(2, S, 2, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    ops.reset_launch_counts()
    err, ratio = _chip_smoke().flash_bwd_reading(torch, q, k, v, do, causal)
    assert ratio <= 1.0, (err, ratio)
    assert ops.launch_counts["flash_attention_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,rep,causal,window", [
    (600, 64, 4, True, 200), (513, 128, 4, True, 100), (300, 64, 1, False, 64),
    (130, 256, 2, True, 40), (77, 256, 2, False, None), (700, 256, 2, True, 256)])
def test_flash_bwd_kernel_window_and_head_dim_256(cuda, S, D, rep, causal, window, dtype):
    """The backward with a sliding window (the wgmma bodies at D 64, 128
    and 256; f32 at D 256 with its resident tile in f32) against the plain
    version's autograd,
    per element under chip_smoke.py's gate (f32: 2e-5; bf16: u (|want| +
    want_abs) + 1e-5)."""
    g = torch.Generator(device=cuda).manual_seed(S * D + rep)
    q, do = (torch.randn(2, S, 2 * rep, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(2, S, 2, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    ops.reset_launch_counts()
    err, ratio = _chip_smoke().flash_bwd_reading(torch, q, k, v, do, causal, window)
    assert ratio <= 1.0, (err, ratio)
    assert ops.launch_counts["flash_attention_bwd"] == 1


@pytest.mark.parametrize("D", [128, 256])
def test_flash_bwd_window_kernel_is_deterministic(cuda, D):
    g = torch.Generator(device=cuda).manual_seed(D)
    q, w = (torch.randn(2, 300, 4, D, generator=g, device=cuda) for _ in range(2))
    k, v = (torch.randn(2, 300, 2, D, generator=g, device=cuda) for _ in range(2))
    grads = []
    for _ in range(2):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (ops.flash_attention(*ts, True, 70) * w).sum().backward()
        grads.append([t.grad for t in ts])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_gemma_engine_cuda_matches_cpu(cuda):
    """Reduced gemma3 (a local layer of window 16, a global one): the
    paged engine on the card gives the cpu engine's greedy tokens, prompts
    shorter and longer than the window, decoding past it."""
    from repro_torch.configs.base import ScheduleGroup

    cfg = dataclasses.replace(
        reduced(get_config("gemma3-4b")), head_dim=256,
        schedule=(ScheduleGroup(pattern=(LayerSpec(window=16), LayerSpec()), repeats=1),))
    run = default_run_config(cfg, ShapeConfig("s", 16, 2, "decode"))
    prompts = [list(np.random.RandomState(i).randint(4, cfg.vocab_size, n))
               for i, n in enumerate((70, 13, 5))]
    outs = []
    for dev in ("cpu", "cuda"):
        eng = PagedServeEngine(build_model(cfg, seed=0, device=dev), run, page=8, n_pages=64,
                               max_slots=3)
        ops.reset_launch_counts()
        rids = [eng.submit(p, 20) for p in prompts]
        got = eng.serve()
        outs.append([got[r] for r in rids])
        if dev == "cuda":
            assert ops.launch_counts["flash_attention"] == 2 * len(prompts)
            assert ops.launch_counts["paged_attention"] == eng.decode_ticks
    assert outs[0] == outs[1]


def test_flash_bwd_kernel_is_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, w = (torch.randn(2, 300, 4, 64, generator=g, device=cuda).bfloat16()
                  for _ in range(4))
    grads = []
    for _ in range(2):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (ops.flash_attention(*ts, False) * w).sum().backward()
        grads.append([t.grad for t in ts])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_train_step_cuda_matches_cpu(cuda):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = dataclasses.replace(reduced(get_config("bert-mlm-120m")),
                              schedule=uniform_schedule(2, LayerSpec()))
    run = default_run_config(cfg, ShapeConfig("t", 96, 4, "train"))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.randint(4, cfg.vocab_size, (4, 96)))
        batches.append({"tokens": toks, "labels": toks,
                        "loss_mask": torch.from_numpy((rng.rand(4, 96) < 0.15).astype(np.float32))})
    losses = {}
    for device in ("cpu", cuda):
        model = build_model(cfg, device="cpu").to(device)
        state, step = init_state(model, run, seed=None), make_train_step(model, run, opt)
        ops.reset_launch_counts()
        losses[str(device)] = [step(state, {k: v.to(device) for k, v in b.items()})[1]["loss"].item()
                               for b in batches]
        if device == cuda:
            assert ops.launch_counts["flash_attention_bwd"] == 2 * len(batches)
            assert ops.launch_counts["fused_xent_bwd"] == len(batches)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# SSM serving slice: the ssd_scan kernel
# ---------------------------------------------------------------------------

def _ssd_inputs(cuda, B, S, H, P, G, N, dtype=torch.float32):
    g = torch.Generator(device=cuda).manual_seed(S + N)
    x = torch.randn(B, S, H, P, generator=g, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=cuda))
    A = -torch.exp(0.5 * torch.randn(H, generator=g, device=cuda))
    Bm, Cm = (torch.randn(B, S, G, N, generator=g, device=cuda).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm


def _assert_within(got, want, want_abs, u_out, rel):
    err = (got.float() - want).abs()
    lim = u_out * want.abs() + rel * want_abs + 1e-6
    assert (err <= lim).all(), (err / lim).max()


def _assert_ssd_close(x, dt, A, Bm, Cm, chunk, y, st):
    """Per element against the plain version on the f32 values, under
    chip_smoke.py's gate (``SSD_REL``): f32 sums in another order differ by
    about 1e-6 of the sum of absolute terms (the plain version with |x|,
    |B|, |C|), and the decay exponents by eps * |cumsum(dt A)| within a
    chunk, which the f32 cumsum of any order carries; bf16 y adds one
    rounding, 2^-8 |y|, and the bf16 body its operands' roundings."""
    f = [t.float() for t in (x, dt, A, Bm, Cm)]
    want_y, want_st = ref.ssd_ref(*f, chunk)
    abs_y, abs_st = ref.ssd_ref(f[0].abs(), f[1], f[2], f[3].abs(), f[4].abs(), chunk)
    u_out, rel_y, rel_st = _chip_smoke().ssd_limits(torch, x, dt, A, Bm.shape[3], chunk)
    _assert_within(y, want_y, abs_y, u_out, rel_y)
    _assert_within(st, want_st, abs_st, 0.0, rel_st)


# ragged S (one partial chunk, a partial last chunk), G = 1, 2, 4, chunk
# 32 / 64 / 96 / 256 (the 32-row and 64-row tile bodies), the serving shape
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 100, 4, 16, 2, 8, 32), (2, 77, 8, 16, 4, 16, 64), (1, 300, 4, 64, 1, 128, 256),
    (1, 1024, 24, 64, 1, 128, 256), (2, 96, 6, 32, 2, 64, 96)])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, G, N, chunk):
    inp = _ssd_inputs(cuda, B, S, H, P, G, N)
    ops.reset_launch_counts()
    y, st = ops.ssd(*inp, chunk)
    _assert_ssd_close(*inp, chunk, y, st)
    assert ops.launch_counts["ssd_scan"] == 1


# the bf16 body of three passes (P 64, N 64 / 128, chunk 64-256) at its
# edges, and the other body at a reduced shape
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 65, 24, 64, 1, 128, 256), (1, 513, 24, 64, 1, 128, 256), (1, 40, 24, 64, 1, 128, 256),
    (1, 1024, 80, 64, 1, 64, 256), (2, 700, 8, 64, 2, 128, 256), (1, 512, 24, 64, 1, 128, 256),
    (2, 200, 8, 64, 4, 64, 64), (1, 333, 6, 64, 3, 128, 128), (1, 450, 4, 64, 2, 64, 192),
    (2, 300, 8, 16, 2, 16, 32)])
def test_ssd_bf16_kernel_near_plain(cuda, B, S, H, P, G, N, chunk):
    """bf16 x, B, C: y in bf16, the state in f32, within the gate's terms
    for the body the shape rule picks."""
    inp = _ssd_inputs(cuda, B, S, H, P, G, N, torch.bfloat16)
    ops.reset_launch_counts()
    y, st = ops.ssd(*inp, chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert ops.launch_counts["ssd_scan"] == 1
    _assert_ssd_close(*inp, chunk, y, st)


@pytest.mark.parametrize("B,S,H,G,N,chunk", [
    (1, 1024, 24, 1, 128, 256), (2, 700, 8, 2, 128, 256), (1, 40, 4, 1, 64, 256),
    (2, 200, 8, 4, 64, 64)])
def test_ssd_bf16_passes_match_their_plain_versions(cuda, B, S, H, G, N, chunk):
    """Each pass of the bf16 body on the previous pass's own output: the
    state pass's chunk updates (within 2^-16, the hi + lo split, of their
    absolute terms) and decays against ``ref.ssd_chunk_states``; the carry
    against ``ref.ssd_carry`` of the kernel's updates (f32 in the same
    order) and its bf16 copy of them (rounded to nearest); the out pass
    against ``ref.ssd_chunk_outputs`` of the kernel's carried states (y's
    bf16 terms)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_passes

    cs = _chip_smoke()
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, 64, G, N, torch.bfloat16)
    u_out, rel_y, rel_st = cs.ssd_limits(torch, x, dt, A, N, chunk)
    f = [t.float() for t in (x, Bm, Cm)]
    run, read = ssd_scan_passes(x, dt, A, Bm, Cm, chunk)
    run("state")
    U, _, dec, _, _ = (t.clone() for t in read())
    want_U, want_dec = ref.ssd_chunk_states(f[0], dt, A, f[1], chunk)
    abs_U, _ = ref.ssd_chunk_states(f[0].abs(), dt, A, f[1].abs(), chunk)
    _assert_within(U, want_U, abs_U, 0.0, rel_st)
    _assert_within(dec, want_dec, want_dec, 0.0, rel_st)
    run("carry")
    states_in, states_bf, _, final, _ = (t.clone() for t in read())
    want_in, want_final = ref.ssd_carry(U, dec)
    abs_in, abs_final = ref.ssd_carry(U.abs(), dec)
    _assert_within(states_in, want_in, abs_in, 0.0, cs.SSD_REL)
    _assert_within(final, want_final, abs_final, 0.0, cs.SSD_REL)
    assert torch.equal(states_bf, states_in.to(torch.bfloat16))
    run("out")
    y = read()[4]
    want_y = ref.ssd_chunk_outputs(f[0], dt, A, f[1], f[2], states_in, chunk)
    abs_y = ref.ssd_chunk_outputs(f[0].abs(), dt, A, f[1].abs(), f[2].abs(),
                                  states_in.abs(), chunk)
    _assert_within(y, want_y, abs_y, u_out, rel_y - cs.SSD_U_SPLIT)


@pytest.mark.parametrize("B,S,H,G,N,chunk", [
    (1, 1024, 24, 1, 128, 256), (2, 700, 8, 2, 128, 256), (1, 40, 4, 1, 64, 256),
    (2, 200, 8, 4, 64, 64), (1, 450, 4, 2, 64, 192)])
def test_ssd_f32_passes_match_their_plain_versions(cuda, B, S, H, G, N, chunk):
    """Each pass of the f32 body on three bf16 pieces, on the previous
    pass's own output, under the f32 gate with no bf16 term: the state
    pass's chunk updates and decays against ``ref.ssd_chunk_states``; the
    carry against ``ref.ssd_carry`` of the kernel's updates (f32 in the
    same order), its three pieces of the carried states equal to
    ``ref.split3`` of them; the out pass against ``ref.ssd_chunk_outputs``
    of the kernel's carried states."""
    from repro_torch.kernels.ssd_scan import ssd_scan_passes

    cs = _chip_smoke()
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, 64, G, N)
    u_out, rel_y, rel_st = cs.ssd_limits(torch, x, dt, A, N, chunk)
    assert u_out == 0.0 and rel_y == rel_st
    run, read = ssd_scan_passes(x, dt, A, Bm, Cm, chunk)
    run("state")
    U, _, dec, _, _ = (t.clone() for t in read())
    want_U, want_dec = ref.ssd_chunk_states(x, dt, A, Bm, chunk)
    abs_U, _ = ref.ssd_chunk_states(x.abs(), dt, A, Bm.abs(), chunk)
    _assert_within(U, want_U, abs_U, 0.0, rel_st)
    _assert_within(dec, want_dec, want_dec, 0.0, rel_st)
    run("carry")
    states_in, pieces, _, final, _ = (t.clone() for t in read())
    want_in, want_final = ref.ssd_carry(U, dec)
    abs_in, abs_final = ref.ssd_carry(U.abs(), dec)
    _assert_within(states_in, want_in, abs_in, 0.0, cs.SSD_REL)
    _assert_within(final, want_final, abs_final, 0.0, cs.SSD_REL)
    assert pieces.shape[0] == 3
    assert all(torch.equal(a, b) for a, b in zip(pieces, ref.split3(states_in)))
    run("out")
    y = read()[4]
    want_y = ref.ssd_chunk_outputs(x, dt, A, Bm, Cm, states_in, chunk)
    abs_y = ref.ssd_chunk_outputs(x.abs(), dt, A, Bm.abs(), Cm.abs(), states_in.abs(), chunk)
    _assert_within(y, want_y, abs_y, 0.0, rel_y)


@pytest.mark.parametrize("N", [64, 128])
def test_ssd_kernel_is_deterministic(cuda, N):
    inp = _ssd_inputs(cuda, 1, 700, 8, 64, 1, N, torch.bfloat16)
    (y1, s1), (y2, s2) = ops.ssd(*inp, 256), ops.ssd(*inp, 256)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ssd_backward_on_the_card_raises(cuda):
    """The backward of ``ops.ssd`` on the card runs the backward kernel,
    with no plain fallback: at a head dim the kernel refuses (P 48; it
    takes 16, 32, 64) it raises."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 64, 2, 48, 1, 16)
    x.requires_grad_(True)
    y, _ = ops.ssd(x, dt, A, Bm, Cm, 32)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="takes P in"):
        y.sum().backward()
    assert not ops.launch_counts


# ragged S, S < chunk, G = 1 and 2, chunk 32 / 96 / 256 (the 32-row and
# 64-row tiles), P 16 / 32 / 64, zero and normal gstate
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 100, 4, 16, 2, 8, 32), (1, 300, 8, 64, 1, 128, 256), (2, 96, 6, 32, 2, 16, 96),
    (1, 40, 4, 64, 2, 64, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_matches_plain_autograd(cuda, B, S, H, P, G, N, chunk, dtype):
    """``ops.ssd``'s backward on the card (one ``ssd_scan_bwd`` launch)
    against the autograd of the plain version on the f32 values, under
    chip_smoke.py's gate: 1e-4 of each gradient's max, plus one bf16
    rounding of dx, dB and dC in bf16; and the same gradients twice."""
    cs = _chip_smoke()
    inp = _ssd_inputs(cuda, B, S, H, P, G, N, dtype)
    g = torch.Generator(device=cuda).manual_seed(7)
    gy = torch.randn(B, S, H, P, generator=g, device=cuda).to(dtype)
    gstate = torch.randn(B, H, N, P, generator=g, device=cuda) * (B % 2)

    def grads():
        xs = [t.detach().clone().requires_grad_(True) for t in inp]
        y, st = ops.ssd(*xs, chunk)
        torch.autograd.backward((y, st), (gy, gstate))
        return [t.grad for t in xs]

    ops.reset_launch_counts()
    got = grads()
    assert ops.launch_counts["ssd_scan_bwd"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, grads()))
    err, ratio = cs.ssd_bwd_reading(torch, *inp, gy, gstate, chunk)
    assert ratio <= 1.0, (err, ratio)


def test_mamba2_engine_cuda_matches_cpu(cuda):
    cfg = dataclasses.replace(reduced(get_config("mamba2-130m")),
                              schedule=uniform_schedule(2, LayerSpec(kind="mamba", has_mlp=False)))
    run = default_run_config(cfg, ShapeConfig("s", 16, 2, "decode"))
    prompts = [np.random.RandomState(i).randint(4, cfg.vocab_size, n).tolist()
               for i, n in enumerate((70, 13, 7))]
    outs = []
    for device in ("cpu", cuda):
        eng = PagedServeEngine(build_model(cfg, device="cpu").to(device), run,
                               page=8, n_pages=64, max_slots=2)
        ops.reset_launch_counts()
        rids = [eng.submit(p, 9) for p in prompts]
        got = eng.serve()
        outs.append([got[r] for r in rids])
    assert outs[0] == outs[1]
    assert ops.launch_counts["ssd_scan"] == 2 * len(prompts)


def test_device_prefetch_and_checkpoint_on_the_card(cuda, tmp_path):
    """Batches through the pinned side-stream prefetch arrive on the card
    equal to the host's, in order, while the consumer's stream is busy; a
    state on the card saved and restored through the checkpoint format
    comes back exactly."""
    from repro_torch.data import DevicePrefetch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import init_state

    rng = np.random.default_rng(0)
    host = [{"tokens": rng.integers(0, 1000, (32, 512)).astype(np.int32)} for _ in range(12)]
    busy = torch.randn(2048, 2048, device=cuda)
    for size in (2, 4):
        pf = DevicePrefetch(iter(host), device=cuda, size=size)
        for b, want in zip(pf, host):
            busy = busy @ busy / 2048
            assert b["tokens"].is_cuda
            assert np.array_equal(b["tokens"].cpu().numpy(), want["tokens"])
        assert pf.puts == len(host)
    cfg = reduced(get_config("bert-mlm-120m"))
    run = default_run_config(cfg, ShapeConfig("c", 16, 2, "train"))
    state = init_state(build_model(cfg, device=cuda, seed=1), run, seed=None)
    ckpt.save_sharded(str(tmp_path), state, step=3)
    like = init_state(build_model(cfg, device=cuda, seed=2), run, seed=None)
    got, _, _ = ckpt.restore_sharded(str(tmp_path), like)
    sd, want = got["params"].state_dict(), state["params"].state_dict()
    assert all(sd[k].is_cuda and torch.equal(sd[k], want[k]) for k in want)


def test_train_loop_takes_batches_already_on_the_card(cuda):
    """TrainLoop.run fed batches whose leaves lie on the card already, or
    in pinned host memory, trains on them as on the same batches in numpy;
    the prefetch hands a leaf on the card out as it is."""
    from repro_torch.data import DevicePrefetch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.runner import StepRunner, TrainLoop

    cfg = reduced(get_config("bert-mlm-120m"))
    run = default_run_config(cfg, ShapeConfig("c", 16, 2, "train"))
    rng = np.random.default_rng(0)
    host = []
    for _ in range(3):
        toks = rng.integers(4, cfg.vocab_size, (2, 16)).astype(np.int32)
        host.append({"tokens": toks, "labels": toks.copy(),
                     "loss_mask": (rng.random((2, 16)) < 0.15).astype(np.float32)})
    on_card = [{k: torch.from_numpy(v).to(cuda) for k, v in b.items()} for b in host]
    pinned = [{k: torch.from_numpy(v).pin_memory() for k, v in b.items()} for b in host]
    first = next(iter(DevicePrefetch(iter(on_card), device=cuda)))
    assert first["tokens"] is on_card[0]["tokens"]
    losses = []
    for batches in (host, on_card, pinned):
        runner = StepRunner(build_model(cfg, device=cuda, seed=1), run, AdamWConfig())
        _, log = TrainLoop(runner, log_every=1).run(iter(batches), 3, seed=0)
        assert log.telemetry["device_puts"] == 3
        losses.append([m["loss"] for m in log.metrics])
    assert losses[1] == losses[0] and losses[2] == losses[0]

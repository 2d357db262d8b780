"""The port's CUDA kernels and its engine on the card (marker ``cuda``).

Without a card every test here skips; on the card run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which a machine
with the card need not have.)

The kernels are held against their plain versions on the same inputs
(f32 at the JAX kernel tests' 2e-5 for attention, 1e-4 and 1e-5 for the
cross-entropy forward and backward), the backward kernels against the
plain version's autograd, the engine on ``cuda`` against the same engine
on ``cpu`` (same greedy tokens) and the train step likewise (losses
within 1e-4)."""
import dataclasses

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

"""The port's CUDA kernels and its engine on the card (marker ``cuda``).

Without a card every test here skips; on the card run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which a machine
with the card need not have.)

The kernels are held against their plain versions on the same inputs
(f32 at the JAX kernel tests' 2e-5), and the engine on ``cuda`` against
the same engine on ``cpu`` (same greedy tokens)."""
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

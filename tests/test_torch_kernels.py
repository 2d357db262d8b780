"""The port's plain flash and paged attention (the CPU path of
``repro_torch.kernels.ops``) against the JAX package's Pallas kernels in
interpret mode and its jnp oracles, on the same numpy inputs, in f32 at
the JAX kernel tests' 2e-5.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.paged_attention import paged_attention_fwd
from repro_torch.kernels import ops

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)


def _flash_inputs(seed, B, S, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))


@pytest.mark.parametrize("causal,rep,window,softcap", [
    (True, 1, None, 0.0),
    (True, 2, None, 0.0),
    (True, 3, 40, 0.0),
    (True, 4, None, 30.0),
    (False, 1, None, 0.0),
    (False, 2, 48, 20.0),
    (False, 3, None, 0.0),
    (False, 4, None, 30.0),
])
def test_flash_plain_matches_pallas(causal, rep, window, softcap):
    q, k, v = _flash_inputs(rep, B=2, S=128, H=2 * rep, Hkv=2, D=32)
    want = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, softcap=softcap,
                               block_q=64, block_k=64, interpret=True)
    ops.reset_launch_counts()
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not ops.launch_counts          # a CPU tensor launches nothing


@pytest.mark.parametrize("S,causal,window", [(77, True, None), (130, False, 50),
                                             (1, True, None)])
def test_flash_plain_ragged_matches_ref(S, causal, window):
    """Ragged S (no tile multiple): the Pallas kernel refuses it, so the
    port is held against the jnp oracle only."""
    q, k, v = _flash_inputs(S, B=1, S=S, H=6, Hkv=2, D=16)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, scale=0.3)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


P, NP, MAXP = 8, 32, 4


def _paged_inputs(seed, B, Hkv, rep, D):
    """Fragmented tables out of the whole pool, trash page 0 in the slots
    past each allocation, ragged positions (incl. page boundaries)."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, Hkv * rep, D)).astype(np.float32)
    kp = rng.standard_normal((NP, P, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NP, P, Hkv, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, NP))
    tables = np.zeros((B, MAXP), np.int32)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        n = 1 + b % MAXP
        tables[b, :n] = perm[b * MAXP:b * MAXP + n]
        lens[b] = min(n * P - 1, (7 * (b + 1) + b * b) % (n * P))
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("rep", [1, 2, 3, 4])
@pytest.mark.parametrize("window,softcap", [(None, 0.0), (5, 0.0), (None, 30.0)])
def test_paged_plain_matches_pallas(rep, window, softcap):
    q, kp, vp, tables, lens = _paged_inputs(rep, B=5, Hkv=2, rep=rep, D=16)
    want = paged_attention_fwd(*map(jnp.asarray, (q, kp, vp, tables, lens)),
                               window=window, softcap=softcap, interpret=True)
    ops.reset_launch_counts()
    got = ops.paged_attention(*map(torch.from_numpy, (q, kp, vp, tables, lens)),
                              window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not ops.launch_counts


def test_paged_plain_matches_ref_with_inactive_slots():
    """Inactive slots (all-zero tables, stale positions) read only the
    trash page, in both packages."""
    q, kp, vp, tables, lens = _paged_inputs(7, B=4, Hkv=2, rep=3, D=16)
    tables[2:] = 0
    lens[2:] = (5, 3 * P + 1)
    want = jref.paged_attention_ref(*map(jnp.asarray, (q, kp, vp, tables, lens)))
    got = ops.paged_attention(*map(torch.from_numpy, (q, kp, vp, tables, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd as tflash
    from repro_torch.kernels.paged_attention import paged_attention_fwd as tpaged

    q, k, v = map(torch.from_numpy, _flash_inputs(0, B=1, S=8, H=2, Hkv=1, D=64))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tflash(q, k, v)
    args = map(torch.from_numpy, _paged_inputs(0, B=2, Hkv=2, rep=2, D=64))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tpaged(*args)
    assert not ops.launch_counts

"""The port's differentiable kernel ops on the CPU (their plain versions
and the plain autograd) against the JAX package: ``ops.xent`` against
the Pallas ``fused_xent`` in interpret mode and ``xent_ref`` at the JAX
kernel tests' 1e-4, its gradient against softmax - onehot, and the
``ops.flash_attention`` gradient against ``jax.grad`` of the JAX op in
interpret mode at 2e-5, all in f32 on the same numpy inputs.  The CUDA
kernels are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_xent import fused_xent
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.kernels.fused_xent import fused_xent_bwd, fused_xent_fwd

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

XENT_TOL = dict(atol=1e-4, rtol=1e-4)      # the JAX fused_xent tests' bar
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)      # the JAX softmax-identity test's bar
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)     # the JAX flash tests' bar


def _xent_inputs(seed, T, V, scale=3.0):
    rng = np.random.RandomState(seed)
    logits = (rng.standard_normal((T, V)) * scale).astype(np.float32)
    labels = rng.randint(0, V, T).astype(np.int32)
    labels[-1] = V - 1                   # the last column, in the last tile
    return logits, labels


# T and V multiples of no tile (the Pallas kernel pads with -1e38, the
# port's kernel masks), a single column, and a vocab of several tiles
@pytest.mark.parametrize("T,V,bt,bv", [
    (64, 1000, 32, 256), (37, 517, 16, 128), (100, 4099, 32, 512),
    (5, 1, 8, 128), (130, 2048, 128, 512)])
def test_xent_plain_matches_pallas(T, V, bt, bv):
    logits, labels = _xent_inputs(T + V, T, V)
    want = np.asarray(fused_xent(jnp.asarray(logits), jnp.asarray(labels),
                                 block_t=bt, block_v=bv, interpret=True))
    oracle = np.asarray(jref.xent_ref(jnp.asarray(logits), jnp.asarray(labels)))
    ops.reset_launch_counts()
    got = ops.xent(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), want, **XENT_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **XENT_TOL)
    assert not ops.launch_counts          # a CPU tensor launches nothing


def test_xent_plain_bf16_logits_match_ref():
    """bf16 logits are read as they are and reduced in f32 in both."""
    logits, labels = _xent_inputs(3, 24, 300)
    lb = torch.from_numpy(logits).bfloat16()
    want = jref.xent_ref(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                         jnp.asarray(labels))
    got = ops.xent(lb, torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **XENT_TOL)


@pytest.mark.parametrize("T,V", [(16, 64), (33, 1001)])
def test_xent_grad_is_softmax_minus_onehot(T, V):
    logits, labels = _xent_inputs(T, T, V, scale=1.0)
    g = np.random.RandomState(T + 1).standard_normal(T).astype(np.float32)
    x = torch.from_numpy(logits).requires_grad_(True)
    ops.xent(x, torch.from_numpy(labels)).backward(torch.from_numpy(g))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = (p - np.eye(V, dtype=np.float32)[labels]) * g[:, None]
    np.testing.assert_allclose(x.grad.numpy(), want, **GRAD_TOL)


def test_xent_grad_matches_jax_custom_vjp():
    logits, labels = _xent_inputs(9, 40, 700)
    g = np.random.RandomState(10).standard_normal(40).astype(np.float32)
    want = jax.grad(lambda l: (jops.xent(l, jnp.asarray(labels)) * g).sum())(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    (ops.xent(x, torch.from_numpy(labels)) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **GRAD_TOL)


def _flash_inputs(seed, B, S, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))


# (causal, rep): the encoder's non-causal MHA, a causal GQA case, and two more
@pytest.mark.parametrize("causal,rep", [(False, 1), (True, 4), (False, 2), (True, 1)])
def test_flash_grad_matches_jax(causal, rep):
    q, k, v, w = _flash_inputs(rep + 10 * causal, B=2, S=128, H=2 * rep, Hkv=2, D=32)
    loss = lambda q_, k_, v_: (jops.flash_attention(q_, k_, v_, causal) * w).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    ops.reset_launch_counts()
    (ops.flash_attention(tq, tk, tv, causal) * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), err_msg=name,
                                   **FLASH_TOL)
    assert not ops.launch_counts


def test_flash_grad_ragged_matches_ref_vjp():
    """Ragged S (the Pallas forward refuses it): the port against the vjp
    of the JAX oracle."""
    q, k, v, w = _flash_inputs(7, B=1, S=77, H=6, Hkv=2, D=16)
    loss = lambda q_, k_, v_: (jref.flash_attention_ref(q_, k_, v_, causal=False,
                                                        scale=0.3) * w).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (ops.flash_attention(tq, tk, tv, False, scale=0.3) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), **FLASH_TOL)


@pytest.mark.parametrize("window,softcap", [(16, 0.0), (None, 30.0)])
def test_flash_bwd_kernel_refuses_window_and_softcap(window, softcap):
    """The backward kernel takes a sliding window (the gemma3 slice) but
    has no softcap yet: a window passes the wrapper's refusal and meets
    its device check, a softcap is refused; the CPU path's plain autograd
    takes both."""
    q, k, v, w = (torch.from_numpy(x) for x in _flash_inputs(1, 1, 64, 2, 2, 64))
    lse = torch.zeros(1, 2, 64)
    err, match = (ValueError, "not on a CUDA device") if window else \
        (NotImplementedError, "no logit softcap")
    with pytest.raises(err, match=match):
        flash_attention_bwd(q, k, v, q, lse, w, window=window, softcap=softcap)
    tq = q.clone().requires_grad_(True)
    ops.flash_attention(tq, k, v, True, window, softcap).sum().backward()
    assert torch.isfinite(tq.grad).all()


def test_backward_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    logits, labels = (torch.from_numpy(x) for x in _xent_inputs(0, 4, 64))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fused_xent_fwd(logits, labels)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fused_xent_bwd(logits, labels, torch.zeros(4), torch.ones(4))
    q, k, v, w = (torch.from_numpy(x) for x in _flash_inputs(0, 1, 64, 2, 2, 64))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 64), w, causal=False)

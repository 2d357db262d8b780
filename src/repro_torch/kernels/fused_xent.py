"""Fused vocabulary cross-entropy: wrappers of the CUDA kernels in
``csrc/fused_xent.cu`` (the port of the JAX package's Pallas
``kernels/fused_xent.py::fused_xent``, and its backward, which the JAX
package takes as the vjp of ``xent_ref``).

Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
FWD_ARGTYPES = [_P] * 4 + [_I] * 4 + [_P]
BWD_ARGTYPES = [_P] * 5 + [_I] * 4 + [_P]


def _check(logits, labels, what):
    for name, t in (("logits", logits), ("labels", labels)):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not on a CUDA device")
    if logits.dtype not in DTYPES:
        raise TypeError(f"{what}: logits dtype {logits.dtype}; takes one of {list(DTYPES)}")
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{what}: logits (T,V) with labels (T,), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: labels dtype {labels.dtype}; takes int32 or int64")


def _vec(logits) -> int:
    """1 when every row starts on a 16-byte boundary (16-byte loads)."""
    per16 = 16 // logits.element_size()
    return int(logits.data_ptr() % 16 == 0 and logits.shape[1] % per16 == 0)


def fused_xent_fwd(logits, labels):
    """logits:(T,V) f32/bf16, labels:(T,) on the card -> (nll, lse), each
    (T,) f32: nll = lse - logits[label], 0 picked for a label outside
    [0, V)."""
    _check(logits, labels, "fused_xent kernel")
    logits = logits.contiguous()
    labels = labels.to(torch.int32).contiguous()
    T, V = logits.shape
    nll = torch.empty((T,), dtype=torch.float32, device=logits.device)
    lse = torch.empty((T,), dtype=torch.float32, device=logits.device)
    if T == 0:
        return nll, lse
    err = _build.function("fused_xent", "fused_xent_fwd", FWD_ARGTYPES)(
        logits.data_ptr(), labels.data_ptr(), nll.data_ptr(), lse.data_ptr(),
        T, V, DTYPES[logits.dtype], _vec(logits),
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_xent kernel launch failed: cudaError {err}")
    _build.launch_counts["fused_xent"] += 1
    return nll, lse


def fused_xent_bwd(logits, labels, lse, g):
    """d logits = (exp(logits - lse) - onehot(label)) * g[:, None] in the
    logits' dtype, for the forward's ``lse`` and the nll gradient ``g``
    ((T,) each, f32)."""
    what = "fused_xent_bwd kernel"
    _check(logits, labels, what)
    T, V = logits.shape
    for name, t in (("lse", lse), ("g", g)):
        if not t.is_cuda or t.shape != (T,):
            raise ValueError(f"{what}: {name} must be a (T,) CUDA tensor, got "
                             f"{tuple(t.shape)} on {t.device}")
    logits = logits.contiguous()
    labels = labels.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    dlogits = torch.empty_like(logits)
    if T == 0:
        return dlogits
    err = _build.function("fused_xent", "fused_xent_bwd", BWD_ARGTYPES)(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dlogits.data_ptr(), T, V, DTYPES[logits.dtype], _vec(logits),
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_xent_bwd kernel launch failed: cudaError {err}")
    _build.launch_counts["fused_xent_bwd"] += 1
    return dlogits

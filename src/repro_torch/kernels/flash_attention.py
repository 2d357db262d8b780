"""Flash attention: wrappers of the CUDA kernels ``csrc/flash_attention.cu``
(the forward, the port of the JAX package's Pallas
``kernels/flash_attention.py::flash_attention_fwd``) and
``csrc/flash_attention_bwd.cu`` (the backward, which the JAX package
takes as the vjp of ``flash_attention_ref``).

Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
FWD_ARGTYPES = [_P] * 5 + [_L] * 12 + [_I] * 8 + [_F, _F, _P]
BWD_ARGTYPES = [_P] * 10 + [_L] * 15 + [_I] * 7 + [_F, _P]


def _check(q, k, v, window, what="flash_attention kernel"):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not on a CUDA device")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} dtype {t.dtype}; "
                            f"takes one of {list(DTYPES)} for all of q, k, v")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be (B,S,H,D) "
                             f"with a contiguous D axis, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{what}: q {tuple(q.shape)} with "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")


def _check_rows_aligned(what, **tensors):
    """The bf16 bodies' alignment: each tensor's base on 16 bytes and its
    strides whole multiples of 8 elements (16 bytes), exactly what a TMA
    tensor map requires of the forward's q, k, v and the backward's q, k,
    v, o and do."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"{what}: bf16 {name} rows must start on 16-byte boundaries")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None, return_lse: bool = False):
    """q:(B,S,H,D), k/v:(B,S,Hkv,D) on the card -> (B,S,H,D) in q's
    dtype, and with ``return_lse`` also the rows' log-sum-exp (B,H,S) in
    f32.  Any S (ragged tiles are masked), any H/Hkv ratio."""
    _check(q, k, v, window)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned("flash_attention kernel", q=q, k=k, v=v)
    B, S, H, D = q.shape
    scale = D**-0.5 if scale is None else scale
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if S == 0:
        return (o, lse) if return_lse else o
    err = _build.function("flash_attention", "flash_attention_fwd", FWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if return_lse else None,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        B, S, H, k.shape[2], D, DTYPES[q.dtype], int(causal),
        int(window or 0), float(softcap), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    _build.launch_counts["flash_attention"] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention_fwd`` for the output gradient
    ``do`` (B,S,H,D), from the forward's inputs, its output ``o`` and its
    ``lse`` (B,H,S) f32.  Gradients come back contiguous in q's dtype;
    for GQA dk and dv sum over each kv head's query heads.  Deterministic:
    no atomics.  Window and softcap are not supported yet."""
    if window is not None or softcap:
        raise NotImplementedError(
            "flash_attention backward kernel: no sliding window or softcap yet")
    what = "flash_attention_bwd kernel"
    _check(q, k, v, window, what)
    B, S, H, D = q.shape
    for name, t in (("o", o), ("do", do)):
        if not t.is_cuda or t.dtype != q.dtype or t.shape != q.shape or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be a {q.dtype} CUDA tensor like q, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{what}: lse must be contiguous (B,H,S) f32, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(what, q=q, k=k, v=v, o=o, do=do)
    scale = D**-0.5 if scale is None else scale
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if S == 0 or B == 0:
        return dq, dk, dv
    # scratch: each row's Delta = rowsum(do * o) and, for the bf16 body,
    # its lse in base 2, in q tiles of 64 rows
    delta = torch.empty((B, H, -(-S // 64), 2, 64), dtype=torch.float32, device=q.device)
    err = _build.function("flash_attention_bwd", "flash_attention_bwd", BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], B, S, H, k.shape[2], D, DTYPES[q.dtype], int(causal),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {err}")
    _build.launch_counts["flash_attention_bwd"] += 1
    return dq, dk, dv

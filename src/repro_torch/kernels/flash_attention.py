"""Flash attention forward: wrapper of the CUDA kernel
``csrc/flash_attention.cu`` (the port of the JAX package's Pallas
``kernels/flash_attention.py::flash_attention_fwd``).

Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("flash_attention").flash_attention_fwd
        P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        f.argtypes = [P] * 4 + [L] * 12 + [I] * 8 + [F, F, P]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on {t.device}, "
                             "not on a CUDA device")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel: {name} dtype {t.dtype}; "
                            f"takes one of {list(DTYPES)} for all of q, k, v")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name} must be (B,S,H,D) "
                             f"with a contiguous D axis, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} with "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention kernel: window {window} < 1")
    if q.dtype == torch.bfloat16:   # the tensor-core body loads rows 16 B at a time
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"flash_attention kernel: bf16 {name} rows must "
                                 "start on 16-byte boundaries")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None):
    """q:(B,S,H,D), k/v:(B,S,Hkv,D) on the card -> (B,S,H,D) in q's
    dtype.  Any S (ragged tiles are masked), any H/Hkv ratio."""
    _check(q, k, v, window)
    B, S, H, D = q.shape
    scale = D**-0.5 if scale is None else scale
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if S == 0:
        return o
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        B, S, H, k.shape[2], D, DTYPES[q.dtype], int(causal),
        int(window or 0), float(softcap), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    _build.launch_counts["flash_attention"] += 1
    return o

"""Paged-attention decode: wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (the port of the JAX package's Pallas
``kernels/paged_attention.py::paged_attention_fwd``).

Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
REPS = (1, 2, 3, 4, 6, 8, 12, 16)     # H / Hkv the kernel is built for
PAGES_PER_SPLIT = 8                   # pages one block reads (see the .cu)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("paged_attention").paged_attention_fwd
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [P] * 8 + [I] * 8 + [I, F, F, P]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _check(q, k_pages, v_pages, block_tables, seq_lens, window):
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if not t.is_cuda:
            raise ValueError(f"paged_attention kernel: {name} is on {t.device}, "
                             "not on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"paged_attention kernel: {name} dtype {t.dtype} "
                            f"!= q dtype {q.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"paged_attention kernel: dtype {q.dtype}; takes "
                        f"one of {list(DTYPES)}")
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_attention kernel: {name} must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention kernel: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    B, H, D = q.shape
    Hkv = k_pages.shape[2]
    if k_pages.shape[3] != D or H % Hkv or H // Hkv not in REPS:
        raise ValueError(f"paged_attention kernel: H={H}, Hkv={Hkv}, D={D} "
                         f"vs pool D={k_pages.shape[3]}; H/Hkv must be in {REPS}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {D} not in {HEAD_DIMS}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_attention kernel: tables {tuple(block_tables.shape)}, "
                         f"seq_lens {tuple(seq_lens.shape)} for B={B}")
    if window is not None and window < 1:
        raise ValueError(f"paged_attention kernel: window {window} < 1")


def paged_attention_fwd(q, k_pages, v_pages, block_tables, seq_lens, *,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None):
    """q:(B,H,D), pools (NP,P,Hkv,D), block_tables (B,maxp) int32 of
    physical page ids in [0, NP), seq_lens (B,) int32 = current query
    position (keys 0..pos live) -> (B,H,D) in q's dtype."""
    _check(q, k_pages, v_pages, block_tables, seq_lens, window)
    B, H, D = q.shape
    _, P, Hkv, _ = k_pages.shape
    maxp = block_tables.shape[1]
    scale = D**-0.5 if scale is None else scale
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or maxp == 0:
        return o.zero_()
    nsplit = -(-maxp // PAGES_PER_SPLIT)
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, H, nsplit, D), dtype=torch.float32, device=q.device)
    err = _kernel()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(),
        B, H, Hkv, D, P, maxp, PAGES_PER_SPLIT, DTYPES[q.dtype],
        int(window or 0), float(softcap), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    _build.launch_counts["paged_attention"] += 1
    return o

"""Paged-attention decode: wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (the port of the JAX package's Pallas
``kernels/paged_attention.py::paged_attention_fwd``).

Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``.  bf16 calls at the shapes of
``wgmma_body`` (every decode of the repo's configs at head dim 64, 80,
128 or 256) run the body on TMA page gathers and wgmma products; f32 calls, and
bf16 at other shapes, run the body on the CUDA cores."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128, 256)
REPS = (1, 2, 3, 4, 6, 8, 12, 16)     # H / Hkv the CUDA-core body is built for
REPS_256 = (1, 2, 4, 8)               # ... at head dim 256
PAGES_PER_SPLIT = 8                   # pages one block of the CUDA-core body reads
SPLIT_KEYS = 64                       # keys one block of the wgmma body reads (the .cu's)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, pools, tables, positions, out, the two scratch buffers; B, H, Hkv, D,
# P, maxp, PAGES_PER_SPLIT, dtype, window; softcap, scale; the stream; the
# pools' page count NP, appended after the stream so that a library built
# before it had that argument (an earlier body, for timing beside this
# one) takes the same call and ignores it
ARGTYPES = [_P] * 8 + [_I] * 8 + [_I, _F, _F, _P, _I]


def wgmma_body(dtype, D: int, P: int, rep: int) -> bool:
    """Whether the kernel runs a call of these shapes on its wgmma body
    (``csrc/paged_attention.cu``'s ``wgmma_shape``, the same rule): bf16,
    head dim 64, 80, 128 or 256, page 8, 16, 32 or 64 tokens, 1 to 16 query
    heads per kv head."""
    return (dtype == torch.bfloat16 and D in HEAD_DIMS and P in (8, 16, 32, 64)
            and 1 <= rep <= 16)


def n_splits(maxp: int, P: int, wgmma: bool) -> int:
    """Splits of a maxp-page table: the partial states the scratch holds."""
    pps = SPLIT_KEYS // P if wgmma else PAGES_PER_SPLIT
    return -(-maxp // pps)


def _kernel():
    return _build.function("paged_attention", "paged_attention_fwd", ARGTYPES)


def _check(q, k_pages, v_pages, block_tables, seq_lens, window):
    """Raises on what the kernel does not take; returns whether the call
    runs on the wgmma body."""
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
    _, P, Hkv, _ = k_pages.shape
    wgmma = H % Hkv == 0 and wgmma_body(q.dtype, D, P, H // Hkv)
    reps = REPS_256 if D == 256 else REPS
    if k_pages.shape[3] != D or H % Hkv or not (wgmma or H // Hkv in reps):
        raise ValueError(f"paged_attention kernel: H={H}, Hkv={Hkv}, D={D} "
                         f"vs pool D={k_pages.shape[3]}; H/Hkv must be in {reps}, "
                         "or 1 to 16 for bf16 at the wgmma body's pages")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {D} not in {HEAD_DIMS}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_attention kernel: tables {tuple(block_tables.shape)}, "
                         f"seq_lens {tuple(seq_lens.shape)} for B={B}")
    if window is not None and window < 1:
        raise ValueError(f"paged_attention kernel: window {window} < 1")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if wgmma and t.data_ptr() % 16:
            raise ValueError(f"paged_attention kernel: {name} must start on a 16-byte "
                             "boundary (the TMA's rule)")
    return wgmma


def paged_attention_fwd(q, k_pages, v_pages, block_tables, seq_lens, *,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None):
    """q:(B,H,D), pools (NP,P,Hkv,D), block_tables (B,maxp) int32 of
    physical page ids in [0, NP), seq_lens (B,) int32 = current query
    position (keys 0..pos live) -> (B,H,D) in q's dtype."""
    wgmma = _check(q, k_pages, v_pages, block_tables, seq_lens, window)
    B, H, D = q.shape
    NP, P, Hkv, _ = k_pages.shape
    maxp = block_tables.shape[1]
    scale = D**-0.5 if scale is None else scale
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or maxp == 0:
        return o.zero_()
    nsplit = n_splits(maxp, P, wgmma)
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, H, nsplit, D), dtype=torch.float32, device=q.device)
    err = _kernel()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(),
        B, H, Hkv, D, P, maxp, PAGES_PER_SPLIT, DTYPES[q.dtype],
        int(window or 0), float(softcap), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream, NP)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    _build.launch_counts["paged_attention"] += 1
    return o

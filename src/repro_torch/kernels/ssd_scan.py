"""Mamba2 SSD chunked scan: wrapper of the CUDA kernel ``csrc/ssd_scan.cu``
(the port of the JAX package's Pallas ``kernels/ssd_scan.py::ssd_scan``).

Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 7 + [_I] * 8 + [_P]


def _check(x, dt, A, B, C, chunk):
    what = "ssd_scan kernel"
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not on a CUDA device")
    if x.dtype not in DTYPES:
        raise TypeError(f"{what}: x dtype {x.dtype}; takes one of {list(DTYPES)}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or B.shape != C.shape:
        raise ValueError(f"{what}: x (B,S,H,P), dt (B,S,H), A (H,), B and C "
                         f"(B,S,G,N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,) \
            or tuple(B.shape[:2]) != (Bb, S) or H % G:
        raise ValueError(f"{what}: x {tuple(x.shape)} with dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B/C {tuple(B.shape)}")
    if P % 16 or N % 4 or N > 128 or chunk % 32 or not 0 < chunk <= 256:
        raise ValueError(f"{what}: takes P a multiple of 16, N a multiple of 4 "
                         f"up to 128, chunk a multiple of 32 up to 256; got "
                         f"P={P}, N={N}, chunk={chunk}")


def _aligned(t):
    """``t`` contiguous and starting on a 16-byte boundary (the kernel
    loads rows of 4 elements at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan_fwd(x, dt, A, B, C, chunk: int):
    """x:(B,S,H,P) f32/bf16, dt:(B,S,H), A:(H,), B,C:(B,S,G,N) on the
    card -> (y:(B,S,H,P) in x's dtype, final_state:(B,H,N,P) f32).  dt
    and A are taken in f32, B and C in x's dtype; any S (the ragged last
    chunk is masked), G dividing H."""
    _check(x, dt, A, B, C, chunk)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    x = _aligned(x)
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    B = _aligned(B.to(x.dtype))
    C = _aligned(C.to(x.dtype))
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    if S == 0 or Bb == 0:
        return y, state.zero_()
    err = _build.function("ssd_scan", "ssd_scan_fwd", ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), Bb, S, H, P, G, N, chunk, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    _build.launch_counts["ssd_scan"] += 1
    return y, state

"""Flash attention: wrappers of the CUDA kernels ``csrc/flash_attention.cu``
(the forward, the port of the JAX package's Pallas
``kernels/flash_attention.py::flash_attention_fwd``) and
``csrc/flash_attention_bwd.cu`` (the backward, which the JAX package
takes as the vjp of ``flash_attention_ref``).

Both run on the tensor cores (wgmma) in either dtype and at every head
dim of ``HEAD_DIMS``; head dim 80 (zamba2-2.7b's) is laid out as 128, its
tensor maps' inner extent 80, so the columns past it load as zeros.
bf16 inputs are the products' operands as they are.  f32 inputs are
first split, by a pre-pass of the same launch, into three bf16
pieces each (x = x0 + x1 + x2, ``ref.split3``), and every f32 product is
the sum of the six bf16 products of pieces i + j <= 2, exact in the f32
accumulator: f32 accuracy (the terms dropped are of order 2^-24 |A|
|B|) at a sixth of the bf16 rate, against the CUDA cores' 67 TFLOP/s.
The f32 backward at head dim 256 keeps its resident tile in f32 and
forms that tile's pieces in registers (``ref.flash_bwd_d256_emulated``
is its arithmetic on the CPU).  The backward takes the logit softcap at
head dim 128, causal (gemma2-27b's attention), in both dtypes
(``ref.flash_bwd_softcap_emulated`` is its arithmetic on the CPU).  The
wrapper allocates the pieces as bf16 scratch.

v may take a head dim Dv other than q's and k's D in exactly one pair,
(D, Dv) = (192, 128), DeepSeek's MLA (q and k 128 + 64 rope columns, v
128): laid out as D 256 (``hopper::box_cols``) in the D-256 bodies and
tiles, the tensor maps keeping each tensor's true inner extent (192 for q,
k, dq, dk; 128 for v, o, dO, dv), so that nothing is padded or copied in
device memory.  The C entries take Dv last.

Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128, 256)
# (D, Dv) pairs besides D == Dv: MLA's q/k head dim and v head dim
SPLIT_HEAD_DIMS = ((192, 128),)
_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# the stream, then the f32 inputs' pieces (null for bf16); the backward
# then its window and its softcap; both then v's head dim Dv, last, so
# that a library built from a source without them takes the same call
FWD_ARGTYPES = [_P] * 5 + [_L] * 12 + [_I] * 8 + [_F, _F, _P, _P, _I]
BWD_ARGTYPES = [_P] * 10 + [_L] * 15 + [_I] * 7 + [_F, _P, _P, _I, _F, _I]
# the backward's softcap bodies: head dims, causal only (gemma2-27b's
# attention is D 128, causal)
BWD_SOFTCAP_HEAD_DIMS = (128,)


def _check(q, k, v, window, what="flash_attention kernel"):
    """Types, layouts and head dims first, then the device: a pair of head
    dims that no body takes is refused wherever its tensors lie."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} dtype {t.dtype}; "
                            f"takes one of {list(DTYPES)} for all of q, k, v")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be (B,S,H,D) "
                             f"with a contiguous D axis, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
    B, S, H, D = q.shape
    Dv = v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{what}: q {tuple(q.shape)} with "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (D != Dv or D not in HEAD_DIMS) and (D, Dv) not in SPLIT_HEAD_DIMS:
        raise ValueError(f"{what}: head dims (q/k {D}, v {Dv}) are neither one of "
                         f"{HEAD_DIMS} nor a pair of {SPLIT_HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not on a CUDA device")


def _check_rows_aligned(what, **tensors):
    """The bf16 bodies' alignment: each tensor's base on 16 bytes and its
    strides whole multiples of 8 elements (16 bytes), exactly what a TMA
    tensor map requires of the forward's q, k, v and the backward's q, k,
    v, o and do."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"{what}: bf16 {name} rows must start on 16-byte boundaries")


def _pieces(q, n_elements):
    """bf16 scratch for the three pieces of each f32 input (None for
    bf16 inputs)."""
    if q.dtype != torch.float32:
        return None
    return torch.empty(3 * n_elements, dtype=torch.bfloat16, device=q.device)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None, return_lse: bool = False):
    """q:(B,S,H,D), k:(B,S,Hkv,D), v:(B,S,Hkv,Dv) on the card ->
    (B,S,H,Dv) in q's dtype, and with ``return_lse`` also the rows'
    log-sum-exp (B,H,S) in f32.  Any S (ragged tiles are masked), any
    H/Hkv ratio."""
    if softcap and v.shape[3] != q.shape[3]:
        raise NotImplementedError(
            f"flash_attention kernel: no logit softcap at head dims (q/k {q.shape[3]}, "
            f"v {v.shape[3]}) (MLA's attention has none)")
    _check(q, k, v, window)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned("flash_attention kernel", q=q, k=k, v=v)
    B, S, H, D = q.shape
    Dv = v.shape[3]
    scale = D**-0.5 if scale is None else scale
    o = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if S == 0:
        return (o, lse) if return_lse else o
    pieces = _pieces(q, q.numel() + k.numel() + v.numel())
    err = _build.function("flash_attention", "flash_attention_fwd", FWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if return_lse else None,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        B, S, H, k.shape[2], D, DTYPES[q.dtype], int(causal),
        int(window or 0), float(softcap), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
        pieces.data_ptr() if pieces is not None else None, Dv)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    _build.launch_counts["flash_attention"] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention_fwd`` for the output gradient
    ``do`` (B,S,H,Dv), from the forward's inputs, its output ``o`` and its
    ``lse`` (B,H,S) f32.  Gradients come back contiguous in q's dtype;
    for GQA dk and dv sum over each kv head's query heads.  Deterministic:
    no atomics.  A logit ``softcap`` (the scores c tanh(s / c), whose
    derivative 1 - tanh^2 dS carries) is built at the head dims of
    ``BWD_SOFTCAP_HEAD_DIMS`` and causal only."""
    what = "flash_attention_bwd kernel"
    if softcap and (q.shape[-1] not in BWD_SOFTCAP_HEAD_DIMS or not causal):
        raise NotImplementedError(
            f"flash_attention backward kernel: no logit softcap at head_dim "
            f"{q.shape[-1]}{'' if causal else ', non-causal'} (built: causal, head_dim "
            f"in {BWD_SOFTCAP_HEAD_DIMS}; ROADMAP B1)")
    if v.shape[3] != q.shape[3] and not causal:
        raise NotImplementedError(
            f"{what}: head dims (q/k {q.shape[3]}, v {v.shape[3]}) are built causal only "
            f"(MLA's attention)")
    _check(q, k, v, window, what)
    B, S, H, D = q.shape
    Dv = v.shape[3]
    for name, t in (("o", o), ("do", do)):
        if not t.is_cuda or t.dtype != q.dtype or t.shape != (B, S, H, Dv) \
                or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be a {q.dtype} CUDA tensor of shape "
                             f"{(B, S, H, Dv)}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{what}: lse must be contiguous (B,H,S) f32, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(what, q=q, k=k, v=v, o=o, do=do)
    scale = D**-0.5 if scale is None else scale
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    if S == 0 or B == 0:
        return dq, dk, dv
    # scratch: each row's Delta = rowsum(do * o) and its lse in base 2, in
    # q tiles of 64 rows, then (f32) the pieces of q, k, v and do
    delta = torch.empty((B, H, -(-S // 64), 2, 64), dtype=torch.float32, device=q.device)
    pieces = _pieces(q, q.numel() + k.numel() + v.numel() + do.numel())
    err = _build.function("flash_attention_bwd", "flash_attention_bwd", BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], B, S, H, k.shape[2], D, DTYPES[q.dtype], int(causal),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        pieces.data_ptr() if pieces is not None else None, int(window or 0),
        float(softcap or 0.0), Dv)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {err}")
    _build.launch_counts["flash_attention_bwd"] += 1
    return dq, dk, dv

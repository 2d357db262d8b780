"""Mamba2 SSD chunked scan: wrappers of the CUDA kernels ``csrc/ssd_scan.cu``
(the port of the JAX package's Pallas ``kernels/ssd_scan.py::ssd_scan``)
and ``csrc/ssd_scan_bwd.cu`` (its backward, the JAX package's vjp of
``ssd_ref``).

Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version in ``kernels/ref.py``.  At P 64, N 64 or 128 and a chunk a
multiple of 64 up to 256 (every SSM config of the repo) the forward runs
a body of three passes (state, carry, out) on TMA loads and wgmma
products: bf16 inputs as they are (``wgmma_body``), f32 ones as three
bf16 pieces (``f32_wgmma_body``), split first into the scratch, with
every f32 intermediate (w x, the carried states, the mapped scores) as
three pieces too.  The reduced test configs' shapes run the one-pass
body on the CUDA cores in both dtypes.  The backward at the shapes of
``bwd_wgmma_body`` (every SSM config of the repo, both dtypes) runs its
products on TMA loads and wgmma: bf16 operands as they are, f32 ones as
three bf16 pieces (``ref.split3``), an f32 intermediate (the pair
weights, the carried states) as hi + lo in bf16 or as three pieces in
f32; its bound is the bf16 peak's (f32: a sixth of it).  The reduced
shapes keep the backward's body on the CUDA cores (f32 arithmetic for
both dtypes)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 7 + [_I] * 8 + [_P]
BWD_ARGTYPES = [_P] * 13 + [_I] * 8 + [_P]
BWD_HEAD_DIMS = (16, 32, 64)    # the backward's P
PASSES = {"state": 1, "carry": 2, "out": 4}   # the three-pass bodies' passes, in order
PASSES_ARGTYPES = [_P] * 7 + [_I] * 9 + [_P]


def _body_shape(P: int, N: int, chunk: int) -> bool:
    """``csrc/ssd_scan.cu``'s ``wgmma_shape``: P 64, N 64 or 128, chunk a
    multiple of 64 up to 256."""
    return P == 64 and N in (64, 128) and chunk % 64 == 0 and 64 <= chunk <= 256


def wgmma_body(dtype, P: int, N: int, chunk: int) -> bool:
    """Whether the kernel runs a call of these shapes on its bf16 body of
    three passes (``csrc/ssd_scan.cu``'s ``wgmma_shape``, the same rule):
    bf16, P 64, N 64 or 128, chunk a multiple of 64 up to 256."""
    return dtype == torch.bfloat16 and _body_shape(P, N, chunk)


def f32_wgmma_body(dtype, P: int, N: int, chunk: int) -> bool:
    """Whether the kernel runs a call of these shapes on its f32 body of
    three passes on three bf16 pieces: f32 at the bf16 body's shapes.  It
    adds no bf16 rounding to f32 arithmetic (every operand and
    intermediate carries f32's 24 bits), so the f32 gate holds it as it
    is."""
    return dtype == torch.float32 and _body_shape(P, N, chunk)


def work_floats(Bb: int, S: int, H: int, P: int, G: int, N: int, chunk: int, dtype) -> int:
    """The f32 scratch (in floats) that follows the final state (B,H,N,P)
    in one forward call's buffer, as the C entry lays it out, nc =
    ceil(S / chunk): for the bf16 body the chunk states (B,nc,H,N,P) in
    f32, again in bf16, and the chunk decays (B,nc,H); for the f32 body
    the chunk states in f32, their three bf16 pieces, the decays, and from
    the next multiple of 4 floats the three bf16 pieces of x (B,S,H,P),
    of B and of C (B,S,G,N) each.  At mamba2-130m's train shape (B 16, S
    1024, H 24, N 128, chunk 256) the f32 body's is 302 MB: 50 MB of
    states, 75 MB of their pieces, 176 MB of the inputs' pieces.  None
    for the one-pass body."""
    nc = -(-S // chunk)
    n_states, n_dec = Bb * nc * H * N * P, Bb * nc * H
    if wgmma_body(dtype, P, N, chunk):
        return n_states * 3 // 2 + n_dec
    if f32_wgmma_body(dtype, P, N, chunk):
        return n_states * 5 // 2 + -(-n_dec // 4) * 4 + 3 * (Bb * S * H * P + 2 * Bb * S * G * N) // 2
    return 0


def bwd_wgmma_body(P: int, N: int, chunk: int) -> bool:
    """Whether the backward runs a call of these shapes on its wgmma body
    (``csrc/ssd_scan_bwd.cu``'s ``wgmma_shape``, the same rule), in either
    dtype: P 64, N 64 or 128, chunk a multiple of 64 up to 256."""
    return P == 64 and N in (64, 128) and chunk % 64 == 0 and 64 <= chunk <= 256


def bwd_work_floats(Bb: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
                    dtype) -> int:
    """The f32 scratch (in floats) of one backward call, as the C entry
    lays it out: the chunk states and their gradients (B,nc,H,N,P) each,
    dB and dC per head (B,S,H,N) each, the chunk decays and dA's partials
    (B,nc,H) each; at the wgmma body's shapes four (B,nc,H,chunk) rows
    from the next multiple of 4 floats on, and with f32 inputs the bf16
    pieces of x, gy, B and C."""
    nc = -(-S // chunk)
    n = 2 * Bb * nc * H * N * P + 2 * Bb * S * H * N + 2 * Bb * nc * H
    if not bwd_wgmma_body(P, N, chunk):
        return n
    n = -(-n // 4) * 4 + 4 * Bb * nc * H * chunk
    if dtype == torch.float32:
        n += 3 * (Bb * S * H * P + Bb * S * G * N)
    return n


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
    loads rows of 4 elements at a time, the TMA whole boxes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _operands(x, dt, A, B, C, chunk):
    """The kernel's operands, its outputs and the f32 buffer that holds
    the final state (B,H,N,P) and, for the three-pass bodies, the scratch
    after it (``work_floats``)."""
    _check(x, dt, A, B, C, chunk)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    x = _aligned(x)
    ins = (x, dt.float().contiguous(), A.float().contiguous(),
           _aligned(B.to(x.dtype)), _aligned(C.to(x.dtype)))
    n_state = Bb * H * N * P
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    buf = torch.empty(n_state + work_floats(Bb, S, H, P, G, N, chunk, x.dtype),
                      dtype=torch.float32, device=x.device)
    return ins, y, buf, (Bb, S, H, P, G, N, chunk)


def ssd_scan_fwd(x, dt, A, B, C, chunk: int):
    """x:(B,S,H,P) f32/bf16, dt:(B,S,H), A:(H,), B,C:(B,S,G,N) on the
    card -> (y:(B,S,H,P) in x's dtype, final_state:(B,H,N,P) f32).  dt
    and A are taken in f32, B and C in x's dtype; any S (the ragged last
    chunk is masked), G dividing H.  One call counts one launch, however
    many kernels it runs.  The final state is a view of the buffer that
    also held the three-pass bodies' scratch (``work_floats``): it keeps
    that buffer alive."""
    ins, y, buf, dims = _operands(x, dt, A, B, C, chunk)
    Bb, S, H, P, G, N, _ = dims
    state = buf[:Bb * H * N * P].view(Bb, H, N, P)
    if S == 0 or Bb == 0:
        return y, state.zero_()
    err = _build.function("ssd_scan", "ssd_scan_fwd", ARGTYPES)(
        *(t.data_ptr() for t in ins), y.data_ptr(), buf.data_ptr(), *dims,
        DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    _build.launch_counts["ssd_scan"] += 1
    return y, state


def ssd_scan_passes(x, dt, A, B, C, chunk: int):
    """The three-pass body of x's dtype one pass at a time, for holding
    each pass against its plain version (``ref.ssd_chunk_states``,
    ``ref.ssd_carry``, ``ref.ssd_chunk_outputs``) on the card.  Returns a
    function ``run(pass_name)`` that launches that pass, and ``read()`` ->
    (chunk states (B,nc,H,N,P) f32, state_in's operand copy (bf16: the
    states in bf16, (B,nc,H,N,P); f32: their three bf16 pieces,
    (3,B,nc,H,N,P)), chunk decays (B,nc,H), final state (B,H,N,P), y): the
    state pass (in f32 after splitting x, B and C into their pieces)
    writes the chunks' own updates and decays, the carry pass replaces the
    updates with the states entering each chunk, writes their operand copy
    and the final state, the out pass writes y.  Counts no launch: no path
    runs it."""
    P, N = x.shape[3], B.shape[3]
    if not (wgmma_body(x.dtype, P, N, chunk) or f32_wgmma_body(x.dtype, P, N, chunk)):
        raise ValueError(f"ssd_scan three-pass body: not its shape, {x.dtype} x "
                         f"{tuple(x.shape)}, B {tuple(B.shape)}, chunk {chunk}")
    ins, y, buf, dims = _operands(x, dt, A, B, C, chunk)
    Bb, S, H, P, G, N, _ = dims
    nc = -(-S // chunk)
    n_state, n_chunks = Bb * H * N * P, Bb * nc * H * N * P
    np_ = 1 if x.dtype == torch.bfloat16 else 3      # state_in's bf16 copies
    fn = _build.function("ssd_scan", "ssd_scan_passes", PASSES_ARGTYPES)

    def run(name):
        err = fn(*(t.data_ptr() for t in ins), y.data_ptr(), buf.data_ptr(), *dims,
                 DTYPES[x.dtype], PASSES[name], torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"ssd_scan {name} pass launch failed: cudaError {err}")

    def read():
        ops = buf[n_state + n_chunks:n_state + n_chunks + n_chunks * np_ // 2]
        ops = ops.view(torch.bfloat16).view(Bb, nc, H, N, P) if np_ == 1 else \
            ops.view(torch.bfloat16).view(3, Bb, nc, H, N, P)
        dec = n_state + n_chunks + n_chunks * np_ // 2
        return (buf[n_state:n_state + n_chunks].view(Bb, nc, H, N, P), ops,
                buf[dec:dec + Bb * nc * H].view(Bb, nc, H), buf[:n_state].view(Bb, H, N, P), y)

    return run, read


def ssd_scan_bwd(x, dt, A, B, C, gy, gstate, chunk: int):
    """The gradients of ``ssd_scan_fwd(x, dt, A, B, C, chunk)`` for the
    output gradients gy:(B,S,H,P) and gstate:(B,H,N,P) on the card ->
    (dx in x's dtype, ddt f32 (B,S,H), dA f32 (H,), dB and dC (B,S,G,N)
    in B's and C's dtypes), as the autograd of ``ref.ssd_ref`` gives them:
    B and C reach the scan in x's dtype, so their gradients are rounded to
    it first.  Recomputes the chunk states from the inputs (nothing of the
    forward is kept); P must be 16, 32 or 64.  One call counts one launch,
    under ``ssd_scan_bwd``, however many kernels it runs."""
    _check(x, dt, A, B, C, chunk)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if P not in BWD_HEAD_DIMS:
        raise ValueError(f"ssd_scan backward kernel: takes P in {BWD_HEAD_DIMS}; got P={P}")
    for name, t, shape in (("gy", gy, (Bb, S, H, P)), ("gstate", gstate, (Bb, H, N, P))):
        if not t.is_cuda or tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan backward kernel: {name} must be a CUDA tensor of "
                             f"shape {shape}; got {tuple(t.shape)} on {t.device}")
    x = _aligned(x)
    ins = (x, dt.float().contiguous(), A.float().contiguous(), _aligned(B.to(x.dtype)),
           _aligned(C.to(x.dtype)), _aligned(gy.to(x.dtype)), _aligned(gstate.float()))
    dx = torch.empty_like(x)
    ddt = torch.empty((Bb, S, H), dtype=torch.float32, device=x.device)
    dA = torch.empty((H,), dtype=torch.float32, device=x.device)
    dB = torch.empty((Bb, S, G, N), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    work = torch.empty(bwd_work_floats(Bb, S, H, P, G, N, chunk, x.dtype),
                       dtype=torch.float32, device=x.device)
    if S == 0 or Bb == 0:
        for t in (dx, ddt, dA, dB, dC):
            t.zero_()
    else:
        err = _build.function("ssd_scan_bwd", "ssd_scan_bwd", BWD_ARGTYPES)(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in (dx, ddt, dA, dB, dC, work)),
            Bb, S, H, P, G, N, chunk, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"ssd_scan backward kernel launch failed: cudaError {err}")
        _build.launch_counts["ssd_scan_bwd"] += 1
    return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype), dC.to(C.dtype)

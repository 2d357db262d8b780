"""Plain PyTorch versions of the kernels: the CPU path and the allclose
targets the CUDA kernels are held against on the card.  Their autograd is
the plain backward (the JAX package's ``jax.vjp`` of its oracles).

Same arithmetic as the JAX package's ``kernels/ref.py``: scores and
softmax in f32, masked logits set to the finite -2e38.  ``ssd_ref`` is
the JAX package's chunked SSD oracle (``models/ssm.py::ssd_chunked``)
and ``ssd_step`` its one-token recurrence, which the decode step runs as
plain code (it has no kernel in either package)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: float = 0.0,
                        scale: Optional[float] = None):
    """q:(B,S,H,D) k:(B,S,Hkv,D) v:(B,S,Hkv,Dv) -> (B,S,H,Dv).  GQA by head
    repeat; v's head dim may differ from q's (MLA: D 192, Dv 128)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = D**-0.5 if scale is None else scale
    qr = q.reshape(B, S, Hkv, rep, D)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qr, k).float() * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= kj > qi - window
    s = s.masked_fill(~ok, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrqk,bkhd->bqhrd", w.to(v.dtype), v)
    return o.reshape(B, S, H, v.shape[-1])


def split3(x):
    """The three bf16 pieces of an f32 tensor, as the flash kernels feed f32
    operands to the bf16 tensor cores: x0 = bf16(x), x1 = bf16(x - x0), x2 =
    bf16(x - x0 - x1).  Each difference is exact in f32, and x0 + x1 + x2
    is within 2^-24 |x| of x."""
    pieces = []
    rest = x.float()
    for _ in range(3):
        p = rest.to(torch.bfloat16)
        pieces.append(p)
        rest = rest - p.float()
    return tuple(pieces)


def piece_product(eq, a, b, na: int, nb: int):
    """``einsum(eq, a, b)`` as the kernels form an f32 product on the bf16
    tensor cores when ``a`` enters as ``na`` pieces of ``split3`` and ``b``
    as ``nb``: the sum over the piece pairs (i, j), i < na, j < nb and i + j
    <= 2, of products of bf16 values summed in f32, the smallest terms
    first.  One piece is the operand rounded to bf16 (exact for an operand
    that holds bf16 values already); two are hi + lo, within 2^-16 of it;
    three carry f32's 24 bits."""
    ap, bp = split3(a)[:na], split3(b)[:nb]
    out = None
    for lv in (2, 1, 0):
        for i in range(lv + 1):
            if i < na and lv - i < nb:
                t = torch.einsum(eq, ap[i].float(), bp[lv - i].float())
                out = t if out is None else out + t
    return out


def flash_bwd_d256_emulated(q, k, v, do, *, causal: bool = True,
                            window: Optional[int] = None, pieces: int = 3,
                            bk: int = 16, qt: int = 16):
    """The f32 flash backward's arithmetic at head dim 256
    (``csrc/flash_attention_bwd.cu``, ``Shape<256, 3>``) on the CPU, for
    holding its precision against the JAX package: -> (dq, dk, dv) f32.

    S = Q K^T from the pieces of both sides, the six pairs smallest first;
    dP = dO V^T likewise (dO's pieces formed in registers on the card, the
    same values) but with the pair (0, 0) summed apart from the five
    smaller pairs and the two added in f32; lse from the f32 forward, P = exp(S scale - lse), Delta =
    rowsum(dO O) and dS = P (dP - Delta) in f32.  dQ adds, key tile by key
    tile (``bk`` keys, in order), a fresh partial of the six piece products
    of dS K; dK and dV add one of dS^T Q and P^T dO per q tile (``qt``
    rows), the rep query heads of a kv head outer and the q tiles inner,
    as dkdv's ring runs.  ``pieces`` = 1 is the same with plain bf16
    operands."""
    q, k, v, do = (x.float() for x in (q, k, v, do))
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = D**-0.5
    kr, vr = (x.repeat_interleave(rep, dim=2) for x in (k, v))

    def res_prod(eq, a, b):
        ap, bp = split3(a)[:pieces], split3(b)[:pieces]
        hi = torch.einsum(eq, ap[0].float(), bp[0].float())
        lo = None
        for lv in (2, 1):
            for i in range(lv + 1):
                if i < pieces and lv - i < pieces:
                    t = torch.einsum(eq, ap[i].float(), bp[lv - i].float())
                    lo = t if lo is None else lo + t
        return hi if lo is None else hi + lo

    qi = torch.arange(S)[:, None]
    kj = torch.arange(S)[None, :]
    hide = torch.zeros((S, S), dtype=torch.bool)
    if causal:
        hide |= kj > qi
    if window is not None:
        hide |= kj <= qi - window
    s32 = torch.einsum("bqhd,bkhd->bhqk", q, kr) * scale          # the forward's, in f32
    lse = torch.logsumexp(s32.masked_fill(hide, NEG_INF), dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s32.masked_fill(hide, NEG_INF) - lse), vr)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]           # (B,H,S,1)
    s = piece_product("bqhd,bkhd->bhqk", q, kr, pieces, pieces)
    p = torch.exp(s * scale - lse).masked_fill(hide, 0.0)
    dp = res_prod("bqhd,bkhd->bhqk", do, vr)
    ds = p * (dp - delta)
    n = 3 if pieces == 3 else 1
    dq = torch.zeros_like(q)
    for k0 in range(0, S, bk):
        dq = dq + piece_product("bhqk,bkhd->bqhd", ds[..., k0:k0 + bk], kr[:, k0:k0 + bk], n, n)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for r in range(rep):
        heads = torch.arange(Hkv) * rep + r
        for q0 in range(0, S, qt):
            rows = slice(q0, q0 + qt)
            pt, dst = p[:, heads, rows], ds[:, heads, rows]
            dv = dv + piece_product("bhqk,bqhd->bkhd", pt, do[:, rows][:, :, heads], n, n)
            dk = dk + piece_product("bhqk,bqhd->bkhd", dst, q[:, rows][:, :, heads], n, n)
    return dq * scale, dk * scale, dv


def flash_bwd_softcap_emulated(q, k, v, do, *, softcap: float, causal: bool = True,
                               window: Optional[int] = None, scale: Optional[float] = None,
                               pieces: int = 3, bk: int = 32, qt: int = 32,
                               derivative: bool = True):
    """The flash backward's softcap arithmetic (``csrc/flash_attention_bwd.cu``,
    the CAP bodies at head dim 128) on the CPU: -> (dq, dk, dv) f32.

    S = Q K^T and dP = dO V^T from the pieces of both sides (``pieces`` =
    3, the six pairs smallest first; 1: bf16 operands), t = tanh(S scale /
    c) in f32, lse from the f32 forward of the capped scores, Delta =
    rowsum(dO O) in f32, P = exp2(c log2(e) t - lse log2(e)) and 1 - t^2
    as one fma (rounded once).  dq forms P (1 - t^2) first and then dS =
    that times (dP - Delta); dkdv forms P (dP - Delta) and then times 1 -
    t^2, as the two passes order them.  dQ adds a fresh partial of dS K a
    ``bk``-key tile, dK and dV one of dS^T Q and P^T dO a ``qt``-row tile,
    the rep heads outer (the D-128 f32 shapes: 32 and 32).
    ``derivative`` False drops 1 - t^2 (what the planted fault does)."""
    q, k, v, do = (x.float() for x in (q, k, v, do))
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = D**-0.5 if scale is None else scale
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    kr, vr = (x.repeat_interleave(rep, dim=2) for x in (k, v))
    qi = torch.arange(S)[:, None]
    kj = torch.arange(S)[None, :]
    hide = torch.zeros((S, S), dtype=torch.bool)
    if causal:
        hide |= kj > qi
    if window is not None:
        hide |= kj <= qi - window
    # the forward's, in f32: the capped scores, their lse and O
    s32 = torch.tanh(torch.einsum("bqhd,bkhd->bhqk", q, kr) * scale / softcap) * softcap
    lse = torch.logsumexp(s32.masked_fill(hide, NEG_INF), dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s32.masked_fill(hide, NEG_INF) - lse), vr)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]            # (B,H,S,1)
    s = piece_product("bqhd,bkhd->bhqk", q, kr, pieces, pieces)
    t = torch.tanh(s * (scale / softcap))
    p = torch.exp2(t * (softcap * log2e) - lse * log2e).masked_fill(hide, 0.0)
    f = (1.0 - t.double() ** 2).float() if derivative else torch.ones_like(t)
    dp = piece_product("bqhd,bkhd->bhqk", do, vr, pieces, pieces) - delta
    ds_q, ds_k = (p * f) * dp, (p * dp) * f
    n = 3 if pieces == 3 else 1
    dq = torch.zeros_like(q)
    for k0 in range(0, S, bk):
        dq = dq + piece_product("bhqk,bkhd->bqhd", ds_q[..., k0:k0 + bk], kr[:, k0:k0 + bk], n, n)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for r in range(rep):
        heads = torch.arange(Hkv) * rep + r
        for q0 in range(0, S, qt):
            rows = slice(q0, q0 + qt)
            pt, dst = p[:, heads, rows], ds_k[:, heads, rows]
            dv = dv + piece_product("bhqk,bqhd->bkhd", pt, do[:, rows][:, :, heads], n, n)
            dk = dk + piece_product("bhqk,bqhd->bkhd", dst, q[:, rows][:, :, heads], n, n)
    return dq * scale, dk * scale, dv


def paged_attention_ref(q, k_pages, v_pages, block_tables, seq_lens, *,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None):
    """Dense version of single-token decode attention through a page table.

    q:(B,H,D) — one query per sequence.
    k_pages/v_pages:(NP,P,Hkv,D) — the paged KV pool.
    block_tables:(B,maxp) int32 — physical page id of each sequence's
    j-th logical page (logical key position p lives in table slot p//P at
    offset p%P; unused slots may point anywhere — masking hides them).
    seq_lens:(B,) int32 — the CURRENT query position per sequence; key
    positions 0..seq_lens[b] inclusive are valid.  Returns (B,H,D).
    """
    B, H, D = q.shape
    NP, P, Hkv, _ = k_pages.shape
    maxp = block_tables.shape[1]
    rep = H // Hkv
    scale = D**-0.5 if scale is None else scale
    tables = block_tables.long()
    k = k_pages[tables].reshape(B, maxp * P, Hkv, D)
    v = v_pages[tables].reshape(B, maxp * P, Hkv, D)
    qr = q.reshape(B, Hkv, rep, D)
    s = torch.einsum("bhrd,bkhd->bhrk", qr, k).float() * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kp = torch.arange(maxp * P, device=q.device)[None, :]
    pos = seq_lens.long()[:, None]
    ok = kp <= pos
    if window is not None:
        ok &= kp > pos - window
    s = s.masked_fill(~ok[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrk,bkhd->bhrd", w.to(v.dtype), v)
    return o.reshape(B, H, D)


def xent_ref(logits, labels):
    """logits:(T,V) f32/bf16, labels:(T,) -> nll:(T,) f32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(lp, labels.long()[:, None], dim=-1)[:, 0]


def ssd_ref(x, dt, A, B, C, chunk: int, initial_state=None):
    """Mamba2 SSD chunked scan.  x:(B,S,H,P) dt:(B,S,H) A:(H,) < 0,
    B,C:(B,S,G,N), head h reading group h // (H/G).  Returns (y:(B,S,H,P)
    in x's dtype, final_state:(B,H,N,P) f32).  f64 inputs are computed in
    f64 throughout (the gate's reference), any other dtype in f32.

    S is padded with zeros to a multiple of ``chunk``: a padded step has
    dt = 0, so its decay is exp(0) = 1 and it adds nothing to the state.
    Within a chunk the decay exponent is masked to -inf above the
    diagonal BEFORE the exp (where the difference is positive and can
    overflow f32), so the autograd of this function has no 0 * inf."""
    Bb, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    L = chunk
    cd = torch.float64 if x.dtype == torch.float64 else torch.float32   # compute dtype
    pad = (-S) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // L

    xs = x.reshape(Bb, nc, L, H, Pd).to(cd)
    dts = dt.reshape(Bb, nc, L, H).to(cd)
    Bh = B.reshape(Bb, nc, L, G, N).repeat_interleave(rep, dim=3).to(x.dtype).to(cd)
    Ch = C.reshape(Bb, nc, L, G, N).repeat_interleave(rep, dim=3).to(x.dtype).to(cd)

    acs = torch.cumsum(dts * A.to(cd), dim=2)               # (B,nc,L,H)
    # each chunk's contribution to the running state, and its decay
    decay_out = torch.exp(acs[:, :, -1:, :] - acs)
    cstate = torch.einsum("bclh,bclhn,bclhp->bchnp", decay_out * dts, Bh, xs)
    cdecay = torch.exp(acs[:, :, -1, :])                      # (B,nc,H)

    state = torch.zeros((Bb, H, N, Pd), dtype=cd, device=x.device) \
        if initial_state is None else initial_state.to(cd)
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = cdecay[:, c, :, None, None] * state + cstate[:, c]
    states_in = torch.stack(states_in, dim=1)                 # (B,nc,H,N,P)

    # inter-chunk contribution
    y_prev = torch.einsum("bclhn,bchnp->bclhp", Ch, states_in) \
        * torch.exp(acs)[..., None]
    # intra-chunk (dual, attention-like) contribution
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]      # (B,nc,L,S,H)
    lmask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(torch.where(lmask[None, None, :, :, None], diff,
                                 float("-inf")))
    seg = scores * lmat.permute(0, 1, 4, 2, 3) \
        * dts.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchls,bcshp->bclhp", seg, xs)

    y = (y_prev + y_intra).reshape(Bb, nc * L, H, Pd)[:, :S]
    return y.to(x.dtype), state


def _chunk_steps(dt, A, S, chunk):
    """(slice, dt, acs) of each chunk of the S steps: dt:(B,n,H) f32 and
    its inclusive cumsum of dt A."""
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        d = dt[:, sl].float()
        yield sl, d, torch.cumsum(d * A.float(), dim=1)


def ssd_chunk_states(x, dt, A, B, chunk: int):
    """The plain version of the bf16 kernel's state pass: each chunk's own
    state update U_c = B^T diag(exp(acs_L - acs) dt) x and its decay
    exp(acs_L), chunk by chunk.  x:(B,S,H,P) dt:(B,S,H) A:(H,)
    B:(B,S,G,N) -> (U:(B,nc,H,N,P), decay:(B,nc,H)), both f32."""
    rep = x.shape[2] // B.shape[2]
    us, decs = [], []
    for sl, d, acs in _chunk_steps(dt, A, x.shape[1], chunk):
        w = torch.exp(acs[:, -1:] - acs) * d                      # (B,n,H)
        Bh = B[:, sl].float().repeat_interleave(rep, dim=2)
        us.append(torch.einsum("blh,blhn,blhp->bhnp", w, Bh, x[:, sl].float()))
        decs.append(torch.exp(acs[:, -1]))
    return torch.stack(us, 1), torch.stack(decs, 1)


def ssd_carry(U, decay, initial_state=None):
    """The plain version of the carry pass: state_in(0) = the initial
    state (zeros), state_in(c + 1) = decay_c state_in(c) + U_c.
    U:(B,nc,H,N,P) decay:(B,nc,H) -> (state_in:(B,nc,H,N,P), the final
    state (B,H,N,P)), f32."""
    state = torch.zeros_like(U[:, 0]) if initial_state is None else initial_state.float()
    states_in = []
    for c in range(U.shape[1]):
        states_in.append(state)
        state = decay[:, c, :, None, None] * state + U[:, c]
    return torch.stack(states_in, 1), state


def ssd_chunk_outputs(x, dt, A, B, C, states_in, chunk: int):
    """The plain version of the out pass: y of each chunk from the state
    entering it, exp(acs_l) (C_l . state_in) + sum over s <= l of (C_l .
    B_s) exp(acs_l - acs_s) dt_s x_s, the exponent masked before the exp.
    -> y:(B,S,H,P) in x's dtype."""
    rep = x.shape[2] // B.shape[2]
    ys = []
    for c, (sl, d, acs) in enumerate(_chunk_steps(dt, A, x.shape[1], chunk)):
        Bh, Ch = (t[:, sl].float().repeat_interleave(rep, dim=2) for t in (B, C))
        n = d.shape[1]
        y = torch.einsum("blhn,bhnp->blhp", Ch, states_in[:, c].float()) \
            * torch.exp(acs)[..., None]
        diff = acs[:, :, None, :] - acs[:, None, :, :]            # (B,l,s,H)
        causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(torch.where(causal[None, :, :, None], diff, float("-inf")))
        seg = torch.einsum("blhn,bshn->blsh", Ch, Bh) * decay * d[:, None]
        ys.append(y + torch.einsum("blsh,bshp->blhp", seg, x[:, sl].float()))
    return torch.cat(ys, 1).to(x.dtype)


def ssd_fwd_wgmma_emulated(x, dt, A, B, C, chunk: int, *, n_in: int, n_mid: int,
                           tile: int = 64):
    """The arithmetic of the f32 forward's wgmma body (``csrc/ssd_scan.cu``)
    on the CPU, for holding its precision against the JAX package: ->
    (y, final state), f32.  Every product of two operands is a
    ``piece_product``: an input (x, B, C) enters as ``n_in`` pieces (the
    kernel's 3), an f32 intermediate (w x in the state pass, the carried
    state_in and the mapped scores map(S) in the out pass) as ``n_mid``
    (the kernel's 3).  The passes and their order: each chunk's U_c =
    B^T diag(w) x, one fresh partial a ``tile``-step tile added in f32; the
    carry in f32 in chunk order; then per chunk and ``tile``-row tile of y,
    exp(acs_l) (C_l . state_in), and for each key tile on or before it S =
    C_l B_s^T, map(S) = S exp(acs_l - acs_s) dt_s (the exponent masked
    before the exp) and map(S) x_s as a fresh partial added in f32."""
    rep = x.shape[2] // B.shape[2]
    S = x.shape[1]
    xs = x.float()
    Bh, Ch = (t.float().repeat_interleave(rep, dim=2) for t in (B, C))

    def tiles(n):
        return [(t0, min(n, t0 + tile)) for t0 in range(0, n, tile)]

    us, decs = [], []
    for sl, d, acs in _chunk_steps(dt, A, S, chunk):
        w = torch.exp(acs[:, -1:] - acs) * d
        u = 0
        for t0, t1 in tiles(d.shape[1]):
            bl = slice(sl.start + t0, sl.start + t1)
            u = u + piece_product("blhn,blhp->bhnp", Bh[:, bl],
                                  w[:, t0:t1, :, None] * xs[:, bl], n_in, n_mid)
        us.append(u)
        decs.append(torch.exp(acs[:, -1]))
    states_in, final = ssd_carry(torch.stack(us, 1), torch.stack(decs, 1))

    ys = []
    for c, (sl, d, acs) in enumerate(_chunk_steps(dt, A, S, chunk)):
        Bc, Cc, xc = (t[:, sl] for t in (Bh, Ch, xs))
        for l0, l1 in tiles(d.shape[1]):
            Cl = Cc[:, l0:l1]
            y = piece_product("blhn,bhnp->blhp", Cl, states_in[:, c], n_in, n_mid) \
                * torch.exp(acs[:, l0:l1, :, None])
            for s0, s1 in tiles(d.shape[1]):
                if s0 > l0:
                    break
                ok = torch.arange(s0, s1)[None, :] <= torch.arange(l0, l1)[:, None]
                diff = acs[:, l0:l1, None, :] - acs[:, None, s0:s1, :]
                E = torch.exp(torch.where(ok[None, :, :, None], diff, float("-inf")))
                mapped = piece_product("blhn,bshn->blsh", Cl, Bc[:, s0:s1], n_in, n_in) \
                    * E * d[:, None, s0:s1]
                y = y + piece_product("blsh,bshp->blhp", mapped, xc[:, s0:s1], n_mid, n_in)
            ys.append(y)
    return torch.cat(ys, 1), final


# The backward of ``ssd_ref``, as the four passes of the backward kernel
# (``csrc/ssd_scan_bwd.cu``).  The states entering each chunk come from the
# forward's state and carry passes (``ssd_chunk_states``, ``ssd_carry``);
# the gradient of the state leaving each chunk, dS_out, from
# ``ssd_chunk_state_grads`` and the reverse carry ``ssd_carry_grads``; each
# chunk's gradients from ``ssd_chunk_grads``, per head; ``ssd_head_sums``
# sums a group's heads and dA's partials.  ``ssd_bwd_ref`` composes them.
# The judge is the autograd of ``ssd_ref``; these are the kernel's passes
# in plain code, held to it on the CPU.

def ssd_chunk_state_grads(dt, A, C, gy, chunk: int):
    """The output side of the backward's first pass: each chunk's
    V_c = sum over l of exp(acs_l) C_l gy_l^T, what y's inter-chunk term
    sends back to the state entering the chunk.  dt:(B,S,H) A:(H,)
    C:(B,S,G,N) gy:(B,S,H,P) -> V:(B,nc,H,N,P) f32."""
    rep = gy.shape[2] // C.shape[2]
    vs = []
    for sl, d, acs in _chunk_steps(dt, A, gy.shape[1], chunk):
        Ch = C[:, sl].float().repeat_interleave(rep, dim=2)
        vs.append(torch.einsum("blh,blhn,blhp->bhnp", torch.exp(acs), Ch, gy[:, sl].float()))
    return torch.stack(vs, 1)


def ssd_carry_grads(V, decay, gstate):
    """The reverse carry, the backward's only sequential part: dS_out of
    the last chunk is the final state's gradient, and dS_out(c - 1) =
    decay_c dS_out(c) + V_c.  V:(B,nc,H,N,P) decay:(B,nc,H)
    gstate:(B,H,N,P) -> dS_out:(B,nc,H,N,P) f32."""
    r = gstate.float()
    out = [None] * V.shape[1]
    for c in reversed(range(V.shape[1])):
        out[c] = r
        r = decay[:, c, :, None, None] * r + V[:, c]
    return torch.stack(out, 1)


def ssd_chunk_grads(x, dt, A, B, C, gy, states_in, dstates, chunk: int):
    """The backward's per-chunk pass, for each (batch, chunk, head): from
    the state entering the chunk S, the gradient of the state leaving it
    dS and gy, with acs the chunk's inclusive cumsum of dt A, acs_L its
    last (real) step, E[l,s] = exp(acs_l - acs_s) for s <= l (the exponent
    masked before the exp), w_s = exp(acs_L - acs_s) dt_s:
      dx_s  = sum_{l>=s} (C_l.B_s) E dt_s gy_l + w_s B_s dS
      dC_l  = exp(acs_l) S gy_l + sum_{s<=l} (gy_l.x_s) E dt_s B_s
      dB_s  = sum_{l>=s} (gy_l.x_s) E dt_s C_l + w_s dS x_s
      ddt_s = sum_{l>=s} (gy_l.x_s)(C_l.B_s) E + exp(acs_L - acs_s) B_s dS x_s
              + A da_s
    where da is the reverse cumsum over the chunk of the gradient of acs
    (y's inter term, the intra pairs at l and at s, the state update at
    s and at L, and the state's decay exp(acs_L) <dS, S> at L), and dA's
    partial is sum_s dt_s da_s.  Returns (dx:(B,S,H,P), ddt:(B,S,H), dA
    partials (B,nc,H), dB and dC of each head (B,S,H,N)), all f32."""
    rep = x.shape[2] // B.shape[2]
    out = {k: [] for k in ("dx", "ddt", "dA", "dB", "dC")}
    for c, (sl, d, acs) in enumerate(_chunk_steps(dt, A, x.shape[1], chunk)):
        xs, gys = x[:, sl].float(), gy[:, sl].float()
        Bh, Ch = (t[:, sl].float().repeat_interleave(rep, dim=2) for t in (B, C))
        S_in, dS = states_in[:, c].float(), dstates[:, c].float()
        n = d.shape[1]
        acs_L = acs[:, -1:]                                       # (B,1,H)
        e = torch.exp(acs)
        to_end = torch.exp(acs_L - acs)
        w = to_end * d
        causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        E = torch.exp(torch.where(causal[None, :, :, None],
                                  acs[:, :, None, :] - acs[:, None, :, :], float("-inf")))
        CB = torch.einsum("blhn,bshn->blsh", Ch, Bh)
        G = torch.einsum("blhp,bshp->blsh", gys, xs)
        R = G * CB * E                                            # (B,l,s,H)
        T = R * d[:, None]
        W = G * E * d[:, None]
        bds = torch.einsum("bshn,bhnp->bshp", Bh, dS)
        u = torch.einsum("bhnp,blhp->blhn", S_in, gys)
        sB = (bds * xs).sum(-1)                                   # (B,s,H)
        out["dx"].append(torch.einsum("blsh,blhp->bshp", CB * E * d[:, None], gys)
                         + w[..., None] * bds)
        out["dC"].append(torch.einsum("blsh,bshn->blhn", W, Bh) + e[..., None] * u)
        out["dB"].append(torch.einsum("blsh,blhn->bshn", W, Ch)
                         + w[..., None] * torch.einsum("bhnp,bshp->bshn", dS, xs))
        dacs = e * (Ch * u).sum(-1) + T.sum(2) - T.sum(1) - w * sB
        last = (w * sB).sum(1) + torch.exp(acs_L[:, 0]) * (dS * S_in).sum((-2, -1))
        dacs = torch.cat([dacs[:, :-1], dacs[:, -1:] + last[:, None]], 1)
        da = dacs.flip(1).cumsum(1).flip(1)
        out["ddt"].append(R.sum(1) + to_end * sB + A.float() * da)
        out["dA"].append((d * da).sum(1))
    return (torch.cat(out["dx"], 1), torch.cat(out["ddt"], 1), torch.stack(out["dA"], 1),
            torch.cat(out["dB"], 1), torch.cat(out["dC"], 1))


def ssd_head_sums(dB_h, dC_h, dA_part, G: int):
    """The backward's last pass: dB and dC (B,S,G,N) as the sums of each
    group's heads, in head order, and dA (H,) as the sum of its (batch,
    chunk) partials."""
    Bb, S, H, N = dB_h.shape
    rep = H // G
    return (dB_h.view(Bb, S, G, rep, N).sum(3), dC_h.view(Bb, S, G, rep, N).sum(3),
            dA_part.sum((0, 1)))


def ssd_bwd_ref(x, dt, A, B, C, gy, gstate, chunk: int):
    """The gradients of ``ssd_ref(x, dt, A, B, C, chunk)`` for (gy, gstate)
    from the backward's passes: (dx, ddt, dA, dB, dC), each in its input's
    dtype (B and C reach the scan in x's dtype, as in ``ssd_ref``)."""
    U, decay = ssd_chunk_states(x, dt, A, B.to(x.dtype), chunk)
    states_in, _ = ssd_carry(U, decay)
    dstates = ssd_carry_grads(ssd_chunk_state_grads(dt, A, C.to(x.dtype), gy, chunk),
                              decay, gstate)
    dx, ddt, dA_part, dB_h, dC_h = ssd_chunk_grads(x, dt, A, B.to(x.dtype), C.to(x.dtype),
                                                   gy, states_in, dstates, chunk)
    dB, dC, dA = ssd_head_sums(dB_h, dC_h, dA_part, B.shape[2])
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(x.dtype).to(B.dtype), dC.to(x.dtype).to(C.dtype))


def ssd_bwd_wgmma_emulated(x, dt, A, B, C, gy, gstate, chunk: int, *, n_in: int,
                           n_mid: int, n_state: Optional[int] = None, tile: int = 64):
    """The arithmetic of the SSD backward's wgmma body
    (``csrc/ssd_scan_bwd.cu``) on the CPU, for holding its precision against
    the JAX package: -> (dx, ddt, dA, dB, dC) f32.  Every product of two
    operands is a ``piece_product``: an input enters as ``n_in`` pieces (1
    for bf16 values, exact; 3 for f32), the pair weights M and W as
    ``n_mid`` pieces (the kernel's 2, hi + lo, in both dtypes), the carried
    states and what they sum (w x and e gy in the state pass) as
    ``n_state`` (the kernel's 3; default ``n_mid``), but for dx's state
    term w_s B_s dS, which takes dS as ``n_mid``.  The passes and
    their order: each chunk's U_c and V_c over its ``tile``-step tiles, the
    two carries in f32; then per chunk sweep 1 (each s tile: the state
    terms w_s B_s dS and w_s x_s dS^T first, then the l tiles on or after
    it: P1 = B_s C_l^T, P2 = x_s gy_l^T, R = P2 P1 E summed along s's row,
    dx_s += M gy_l and dB_s += W C_l with M = P1 E dt_s and W = P2 E dt_s)
    and sweep 2 (each l tile: e_l gy_l S^T, then the s tiles on or before
    it: R dt_s summed along l's row, dC_l += W B_s); acs's gradient, its
    reverse cumsum, ddt and dA's partials in f32; a group's heads summed
    in head order."""
    rep = x.shape[2] // B.shape[2]
    S = x.shape[1]
    n_state = n_state or n_mid
    xs, gys = x.float(), gy.float()
    Bh, Ch = (t.float().repeat_interleave(rep, dim=2) for t in (B, C))

    def tiles(n):
        return [(t0, min(n, t0 + tile)) for t0 in range(0, n, tile)]

    us, vs, decs = [], [], []
    for sl, d, acs in _chunk_steps(dt, A, S, chunk):
        w = torch.exp(acs[:, -1:] - acs) * d
        e = torch.exp(acs)
        u = v = 0
        for t0, t1 in tiles(d.shape[1]):
            bl = slice(sl.start + t0, sl.start + t1)
            u = u + piece_product("blhn,blhp->bhnp", Bh[:, bl],
                                  w[:, t0:t1, :, None] * xs[:, bl], n_in, n_state)
            v = v + piece_product("blhn,blhp->bhnp", Ch[:, bl],
                                  e[:, t0:t1, :, None] * gys[:, bl], n_in, n_state)
        us.append(u)
        vs.append(v)
        decs.append(torch.exp(acs[:, -1]))
    decay = torch.stack(decs, 1)
    states_in, _ = ssd_carry(torch.stack(us, 1), decay)
    dstates = ssd_carry_grads(torch.stack(vs, 1), decay, gstate)

    out = {k: [] for k in ("dx", "ddt", "dA", "dB", "dC")}
    for c, (sl, d, acs) in enumerate(_chunk_steps(dt, A, S, chunk)):
        n = d.shape[1]
        Bc, Cc, xc, gc = (t[:, sl] for t in (Bh, Ch, xs, gys))
        S_in, dS = states_in[:, c], dstates[:, c]
        acs_L = acs[:, -1:]
        to_end = torch.exp(acs_L - acs)
        w = to_end * d
        e = torch.exp(acs)

        def E(l0, l1, s0, s1):  # (B, l, s, H): exp(acs_l - acs_s), s <= l
            ok = torch.arange(s0, s1)[None, :] <= torch.arange(l0, l1)[:, None]
            diff = acs[:, l0:l1, None, :] - acs[:, None, s0:s1, :]
            return torch.exp(torch.where(ok[None, :, :, None], diff, float("-inf")))

        dx, dBh, dCh = (torch.zeros_like(t) for t in (xc, Bc, Cc))
        ddt1, dacs1, dacs2, qv = (torch.zeros_like(d) for _ in range(4))
        for s0, s1 in tiles(n):                        # sweep 1: an s tile
            Bs, xsr, ds_ = Bc[:, s0:s1], xc[:, s0:s1], d[:, s0:s1]
            o2 = piece_product("bshp,bhnp->bshn", xsr, dS, n_in, n_state)
            o1 = piece_product("bshn,bhnp->bshp", Bs, dS, n_in, n_mid)
            q = (Bs * o2).sum(-1)
            ws = w[:, s0:s1]
            o1, o2 = o1 * ws[..., None], o2 * ws[..., None]
            rs = 0
            for l0, l1 in tiles(n):
                if l0 < s0:
                    continue
                Cl, gl = Cc[:, l0:l1], gc[:, l0:l1]
                p1 = piece_product("bshn,blhn->bslh", Bs, Cl, n_in, n_in)
                p2 = piece_product("bshp,blhp->bslh", xsr, gl, n_in, n_in)
                Et = E(l0, l1, s0, s1).transpose(1, 2)    # (B, s, l, H)
                rs = rs + (p2 * p1 * Et).sum(2)
                wgt = Et * ds_[:, :, None]
                o1 = o1 + piece_product("bslh,blhp->bshp", p1 * wgt, gl, n_mid, n_in)
                o2 = o2 + piece_product("bslh,blhn->bshn", p2 * wgt, Cl, n_mid, n_in)
            ddt1[:, s0:s1] = to_end[:, s0:s1] * q + rs
            qv[:, s0:s1] = ws * q
            dacs1[:, s0:s1] = -ws * q - ds_ * rs
            dx[:, s0:s1], dBh[:, s0:s1] = o1, o2
        for l0, l1 in tiles(n):                        # sweep 2: an l tile
            Cl, gl = Cc[:, l0:l1], gc[:, l0:l1]
            o2 = piece_product("blhp,bhnp->blhn", gl, S_in, n_in, n_state)
            el = e[:, l0:l1]
            q = (Cl * o2).sum(-1)
            o2 = o2 * el[..., None]
            rs = 0
            for s0, s1 in tiles(n):
                if s0 > l0:
                    break
                Bs, xsr, ds_ = Bc[:, s0:s1], xc[:, s0:s1], d[:, s0:s1]
                p1 = piece_product("blhn,bshn->blsh", Cl, Bs, n_in, n_in)
                p2 = piece_product("blhp,bshp->blsh", gl, xsr, n_in, n_in)
                wgt = E(l0, l1, s0, s1) * ds_[:, None]
                rs = rs + (p2 * p1 * wgt).sum(2)
                o2 = o2 + piece_product("blsh,bshn->blhn", p2 * wgt, Bs, n_mid, n_in)
            dacs2[:, l0:l1] = el * q + rs
            dCh[:, l0:l1] = o2
        dacs = dacs1 + dacs2
        last = qv.sum(1) + torch.exp(acs_L[:, 0]) * (dS * S_in).sum((-2, -1))
        dacs = torch.cat([dacs[:, :-1], dacs[:, -1:] + last[:, None]], 1)
        da = dacs.flip(1).cumsum(1).flip(1)
        for k, val in (("dx", dx), ("ddt", ddt1 + A.float() * da), ("dA", (d * da).sum(1)),
                       ("dB", dBh), ("dC", dCh)):
            out[k].append(val)
    dB, dC, dA = ssd_head_sums(torch.cat(out["dB"], 1), torch.cat(out["dC"], 1),
                               torch.stack(out["dA"], 1), B.shape[2])
    return torch.cat(out["dx"], 1), torch.cat(out["ddt"], 1), dA, dB, dC


def ssd_step(state, x, dt, A, B, C):
    """One recurrent step.  state:(B,H,N,P) x:(B,H,P) dt:(B,H) B,C:(B,G,N)
    -> (y:(B,H,P) in x's dtype, new state (B,H,N,P) f32)."""
    rep = x.shape[1] // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).float()              # (B,H,N)
    Ch = C.repeat_interleave(rep, dim=1).float()
    dt = dt.float()
    dA = torch.exp(dt * A.float())                            # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt, Bh, x.float())
    new = dA[..., None, None] * state.float() + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, new)
    return y.to(x.dtype), new

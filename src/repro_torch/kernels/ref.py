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
    """q:(B,S,H,D) k,v:(B,S,Hkv,D) -> (B,S,H,D).  GQA by head repeat."""
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
    return o.reshape(B, S, H, D)


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
    in x's dtype, final_state:(B,H,N,P) f32).

    S is padded with zeros to a multiple of ``chunk``: a padded step has
    dt = 0, so its decay is exp(0) = 1 and it adds nothing to the state.
    Within a chunk the decay exponent is masked to -inf above the
    diagonal BEFORE the exp (where the difference is positive and can
    overflow f32), so the autograd of this function has no 0 * inf."""
    Bb, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    L = chunk
    pad = (-S) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // L

    xs = x.reshape(Bb, nc, L, H, Pd).float()
    dts = dt.reshape(Bb, nc, L, H).float()
    Bh = B.reshape(Bb, nc, L, G, N).repeat_interleave(rep, dim=3).to(x.dtype).float()
    Ch = C.reshape(Bb, nc, L, G, N).repeat_interleave(rep, dim=3).to(x.dtype).float()

    acs = torch.cumsum(dts * A.float(), dim=2)               # (B,nc,L,H)
    # each chunk's contribution to the running state, and its decay
    decay_out = torch.exp(acs[:, :, -1:, :] - acs)
    cstate = torch.einsum("bclh,bclhn,bclhp->bchnp", decay_out * dts, Bh, xs)
    cdecay = torch.exp(acs[:, :, -1, :])                      # (B,nc,H)

    state = torch.zeros((Bb, H, N, Pd), dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state.float()
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

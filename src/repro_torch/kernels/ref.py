"""Plain PyTorch versions of the kernels: the CPU path and the allclose
targets the CUDA kernels are held against on the card.

Same arithmetic as the JAX package's ``kernels/ref.py``: scores and
softmax in f32, masked logits set to the finite -2e38."""
from __future__ import annotations

from typing import Optional

import torch

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

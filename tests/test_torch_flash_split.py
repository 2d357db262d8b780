"""The precision argument of the f32 flash bodies, on the CPU.

On the card an f32 flash forward or backward splits each f32 operand into
three bf16 pieces (``ref.split3``) and builds every f32 product as the sum
of the six bf16 products of pieces i + j <= 2, each exact in an f32
accumulator (``csrc/hopper.cuh``).  Here the same arithmetic is emulated
in torch (bf16 pieces, products summed in f32) and held against the JAX
package's ``flash_attention_ref`` and its ``jax.vjp`` on the same numpy
inputs, at the flat 2e-5 that ``chip_smoke.py`` holds the f32 kernels to
(``F32_TOL``, the JAX kernel tests' bar).  One piece (plain bf16
operands) misses that bar, so the gate can tell the pieces apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

F32_TOL = 2e-5
NEG_INF = -2.0e38


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 5e37])
def test_split3_pieces_sum_back_to_the_f32_input(scale):
    """Three bf16-valued pieces, the first bf16(x), summing to x within
    2^-24 |x|: f32's 24 bits of mantissa (the two differences are exact,
    and rounding the third piece to 8 bits leaves at most 2^-24 |x|).
    Normal, tiny (1e-30: the last piece 2^-16 below it is still normal),
    huge (normals times 5e37, and 3e38, under bf16's largest finite
    3.39e38) and zero inputs; every piece of 0 is 0."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * scale
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1.0 + 2**-23, -(1.0 + 2**-23)]) * scale,
                   torch.tensor([3e38, -3e38, 0.0])]).float()
    pieces = ref.split3(x)
    assert len(pieces) == 3 and all(p.dtype == torch.bfloat16 for p in pieces)
    assert torch.equal(pieces[0], x.to(torch.bfloat16))
    total = sum(p.double() for p in pieces)
    assert torch.isfinite(total).all()
    assert ((total - x.double()).abs() <= 2.0**-24 * x.double().abs()).all()
    zero = x == 0
    assert all((p[zero] == 0).all() for p in pieces)


def _pieces(x, n):
    return [p.float() for p in ref.split3(x)[:n]]


def _prod(eq, a, b, n):
    """The f32 product ``einsum(eq, a, b)`` as the kernels form it: the
    sum over the piece pairs i + j < n of bf16 products summed in f32,
    the smallest terms first."""
    ap, bp = _pieces(a, n), _pieces(b, n)
    out = None
    for lv in range(n - 1, -1, -1):
        for i in range(lv + 1):
            t = torch.einsum(eq, ap[i], bp[lv - i])
            out = t if out is None else out + t
    return out


def _emulated(q, k, v, do, causal, n):
    """(o, dq, dk, dv) of the f32 bodies on n pieces: S and dP, P V, dS K,
    P^T dO and dS^T Q each a sum of piece products; softmax, lse, Delta =
    rowsum(dO O) and dS = P (dP - Delta) in f32.  q, do (B,S,H,D); k, v
    (B,S,Hkv,D); GQA as the kernels: dk and dv sum over the rep query heads
    of their kv head."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    scale = D**-0.5
    kr, vr = (x.repeat_interleave(rep, dim=2) for x in (k, v))
    s = _prod("bqhd,bkhd->bhqk", q, kr, n) * scale
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), NEG_INF)
    m = s.max(-1, keepdim=True).values
    p = torch.exp(s - m)
    lsum = p.sum(-1, keepdim=True)
    o = _prod("bhqk,bkhd->bqhd", p, vr, n) / lsum.permute(0, 2, 1, 3)
    pn = p / lsum                                            # exp(s - lse)
    dp = _prod("bqhd,bkhd->bhqk", do, vr, n)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]     # (B,H,S,1)
    ds = pn * (dp - delta)
    dq = _prod("bhqk,bkhd->bqhd", ds, kr, n) * scale
    dk = _prod("bhqk,bqhd->bkhd", ds, q, n) * scale
    dv = _prod("bhqk,bqhd->bkhd", pn, do, n)
    kv_sum = lambda x: x.unflatten(2, (-1, rep)).sum(3)
    return o, dq, kv_sum(dk), kv_sum(dv)


def _inputs(seed, B, S, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D))]


def _reference(q, k, v, do, causal):
    """The JAX oracle's output and its vjp for ``do``, as numpy."""
    o, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_ref(q_, k_, v_, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in (o, *vjp(jnp.asarray(do)))]


# reduced copies of chip_smoke.py's f32 gate cases (B, S, H, Hkv, D, causal):
# rep 1, 4 and 12, D 64 and 128, causal and not, S ragged against the tiles
CASES = [
    (1, 128, 2, 2, 64, True),       # rep 1, causal (FLASH_BWD_CASES' first)
    (1, 100, 4, 1, 128, True),      # rep 4, D 128, ragged S
    (1, 80, 12, 1, 64, False),      # rep 12, non-causal, ragged
    (1, 77, 6, 2, 64, False),       # one ragged tile and a half
    (1, 96, 12, 12, 64, False),     # bert-mlm-120m's heads (BERT_ATTN)
    (1, 65, 12, 1, 128, True),      # rep 12, D 128, a key past a tile
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_three_pieces_hold_the_f32_bar(case):
    """Forward and every gradient of the six-product emulation within the
    flat 2e-5 of the JAX oracle and its vjp, by a margin (under 1/4 of the
    bar: the card's own accumulation order must fit in the rest)."""
    *shape, causal = case
    x = _inputs(sum(shape), *shape)
    want = _reference(*x, causal)
    got = _emulated(*map(torch.from_numpy, x), causal, 3)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        err = np.abs(g.numpy() - w).max()
        assert err <= F32_TOL / 4, (name, err)


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "-".join(map(str, c)))
def test_one_piece_misses_the_f32_bar(case):
    """Plain bf16 operands (one piece, one product) miss 2e-5 on the
    output and on every gradient: the gate tells the pieces apart."""
    *shape, causal = case
    x = _inputs(sum(shape), *shape)
    want = _reference(*x, causal)
    got = _emulated(*map(torch.from_numpy, x), causal, 1)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert np.abs(g.numpy() - w).max() > F32_TOL, name

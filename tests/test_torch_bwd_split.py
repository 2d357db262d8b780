"""The precision argument of the two backward bodies redesigned onto the
tensor cores, on the CPU.

The f32 flash backward at head dim 256 keeps its resident tile in f32 and
forms that tile's three bf16 pieces in registers; S and dP add the pair (0,
0) apart from the five smaller pairs; dQ, dK and dV add a fresh partial of
six piece products per streamed tile (``ref.flash_bwd_d256_emulated``).
The SSD backward's wgmma body takes bf16 inputs as they are and f32 ones as
three pieces, the pair weights M and W as hi + lo, and the carried states
and what they sum (w x, e gy) as three pieces (``ref.ssd_bwd_wgmma_emulated``).
Here that arithmetic is emulated in torch and held against the JAX
package's oracles and their ``jax.vjp`` on
the same numpy inputs, at the bars ``chip_smoke.py`` holds the kernels to:
2e-5 flat for the flash backward (against the function in f64, as the card
gate reads it), 1e-4 of each gradient's largest value for the SSD backward.
Dropping a piece misses each bar, so the gates tell the designs apart."""
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
SSD_BWD_REL, SSD_BWD_ATOL = 1e-4, 1e-6


def _flash_inputs(seed, B, S, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D))]


def _flash_jax(q, k, v, do, causal, window):
    """The JAX oracle's vjp for ``do``, as numpy."""
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_ref(q_, k_, v_, causal=causal,
                                                                 window=window),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(do))]


def _flash_f64(q, k, v, do, causal, window):
    """The gradients of the plain function evaluated in f64."""
    xs = [torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v)]
    o = ref.flash_attention_ref(*xs, causal=causal, window=window)
    return [g.numpy() for g in torch.autograd.grad(o, xs, torch.from_numpy(do).double())]


# reduced copies of chip_smoke.py's D-256 backward cases (B, S, H, Hkv, D,
# causal, window): gemma3's heads (8 / 4) with its window cut to the length
# and without, the 16-row tiles' ragged edges, rep 1 and 2
FLASH_CASES = [
    (1, 130, 8, 4, 256, True, 40),
    (1, 96, 8, 4, 256, True, None),
    (1, 77, 4, 4, 256, True, 16),
    (2, 33, 4, 2, 256, True, None),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_d256_flash_backward_holds_the_f32_bar(case):
    """Every gradient of the D-256 emulation within 2e-5 of the function in
    f64 (the card gate's reference) and of the JAX oracle's vjp, by a
    margin (under 1/4 of the bar: the card's own accumulation order must
    fit in the rest)."""
    *shape, causal, window = case
    x = _flash_inputs(sum(shape), *shape)
    got = ref.flash_bwd_d256_emulated(*map(torch.from_numpy, x), causal=causal, window=window)
    for want in (_flash_f64(*x, causal, window), _flash_jax(*x, causal, window)):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = np.abs(g.numpy() - w).max()
            assert err <= F32_TOL / 4, (name, err)


@pytest.mark.parametrize("case", FLASH_CASES[:2], ids=lambda c: "-".join(map(str, c)))
def test_d256_flash_backward_on_one_piece_misses_the_bar(case):
    """The same streaming order on plain bf16 operands (one piece) misses
    2e-5 on every gradient."""
    *shape, causal, window = case
    x = _flash_inputs(sum(shape), *shape)
    got = ref.flash_bwd_d256_emulated(*map(torch.from_numpy, x), causal=causal, window=window,
                                      pieces=1)
    for name, g, w in zip(("dq", "dk", "dv"), got, _flash_f64(*x, causal, window)):
        assert np.abs(g.numpy() - w).max() > F32_TOL, name


def test_d256_flash_emulation_sums_the_pairs_it_names():
    """The emulation's S = Q K^T on three pieces is the f32 product to
    f32's precision, and on one piece it is the product of the bf16
    roundings: its pieces and pairs are the ones the docstring names."""
    g = torch.Generator().manual_seed(3)
    a, b = torch.randn(5, 256, generator=g), torch.randn(7, 256, generator=g)
    three = ref.piece_product("id,jd->ij", a, b, 3, 3)
    assert (three.double() - a.double() @ b.double().T).abs().max() < 1e-5
    one = ref.piece_product("id,jd->ij", a, b, 1, 1)
    bf = a.bfloat16().float() @ b.bfloat16().float().T
    assert torch.allclose(one, bf, rtol=0, atol=1e-4)


def _ssd_inputs(seed, B, S, H, P, G, N, bf16):
    """x, dt, A, B, C, gy, gstate as in chip_smoke.py's SSD_BWD gate: A < 0
    log-uniform in [0.01, 1], dt softplus of a normal; with ``bf16`` the
    inputs the scan reads in bf16 (x, B, C, gy) hold bf16 values."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    A = -np.exp(np.log(0.01) * rng.rand(H)).astype(np.float32)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    x, Bm, Cm, gy = f(B, S, H, P), f(B, S, G, N), f(B, S, G, N), f(B, S, H, P)
    if bf16:
        x, Bm, Cm, gy = (torch.from_numpy(t).bfloat16().float().numpy() for t in (x, Bm, Cm, gy))
    return x, dt, A, Bm, Cm, gy, f(B, H, N, P)


def _ssd_jax(x, dt, A, Bm, Cm, gy, gstate, chunk):
    """The vjp of the JAX package's ``ssd_ref`` for (gy, gstate), as numpy."""
    _, vjp = jax.vjp(lambda *a: jref.ssd_ref(*a, chunk), *map(jnp.asarray, (x, dt, A, Bm, Cm)))
    return [np.asarray(g) for g in vjp((jnp.asarray(gy), jnp.asarray(gstate)))]


def _ssd_ratio(got, want):
    """The worst error / limit over the five gradients, per element at the
    gate's 1e-4 of each gradient's largest value (+ 1e-6)."""
    return max((np.abs(g.numpy() - w) / (SSD_BWD_REL * np.abs(w).max() + SSD_BWD_ATOL)).max()
               for g, w in zip(got, want))


# the wgmma body's shapes (P 64, N 64 or 128, chunk a multiple of 64),
# reduced: (B, S, H, P, G, N, chunk); G 1 and G > 1, S ragged inside a tile
# and inside the chunk, several chunks
SSD_CASES = [
    (1, 150, 4, 64, 1, 64, 64),
    (2, 200, 4, 64, 2, 64, 128),
    (1, 90, 6, 64, 3, 128, 64),
]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_backward_body_holds_the_gate(case, bf16):
    """The emulated body (inputs as they are in bf16, as three pieces in
    f32; M and W hi + lo, the states three pieces) with a non-zero gstate,
    against the vjp of the JAX oracle on the same values, within the
    gate's 1e-4 by a margin (under 1/4)."""
    B, S, H, P, G, N, chunk = case
    ins = _ssd_inputs(sum(case), B, S, H, P, G, N, bf16)
    want = _ssd_jax(*ins, chunk)
    got = ref.ssd_bwd_wgmma_emulated(*map(torch.from_numpy, ins), chunk,
                                     n_in=1 if bf16 else 3, n_mid=2, n_state=3)
    assert _ssd_ratio(got, want) <= 0.25


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SSD_CASES[:2], ids=lambda c: "-".join(map(str, c)))
def test_ssd_backward_body_without_the_lo_piece_fails_the_gate(case, bf16):
    """The intermediates as bf16 alone (the lo piece dropped) miss the
    1e-4 gate in both dtypes."""
    B, S, H, P, G, N, chunk = case
    ins = _ssd_inputs(sum(case), B, S, H, P, G, N, bf16)
    got = ref.ssd_bwd_wgmma_emulated(*map(torch.from_numpy, ins), chunk,
                                     n_in=1 if bf16 else 3, n_mid=1)
    assert _ssd_ratio(got, _ssd_jax(*ins, chunk)) > 1.0


def _ssd_grads64(ins, chunk):
    """The plain function's five gradients in f64 (the card gate's
    reference) for the inputs (x, dt, A, B, C, gy, gstate) as torch."""
    xd = [t.double().requires_grad_(True) for t in ins[:5]]
    return torch.autograd.grad(ref.ssd_ref(*xd, chunk), xd,
                               (ins[5].double(), ins[6].double()))


@pytest.mark.parametrize("seed,rho", [(0, 0.02), (1, 0.02), (2, 0.05)])
def test_ssd_backward_states_in_three_pieces_hold_da_where_it_cancels(seed, rho):
    """dA sums terms over every step of every chunk; with gstate scaled per
    head so that each head's dA is ``rho`` of its value at gstate 0, the
    terms cancel 20-50 fold.  There the body with the carried states (and
    w x, e gy) as hi + lo misses dA by more than 3x the plain f32
    autograd's own error against f64, and as three pieces, the kernel's
    design, stays within 2x of it (at rho 0.02 f32 itself is at or past
    the gate's 1e-4 of the largest |dA|: PERF.md §7)."""
    g = torch.Generator().manual_seed(seed)
    B, S, H, P, G, N, chunk = ((2, 300, 4, 64, 2, 64, 128), (1, 450, 4, 64, 1, 128, 128),
                               (2, 300, 4, 64, 2, 64, 128))[seed]
    f = lambda *s: torch.randn(*s, generator=g)
    A = -torch.exp(np.log(0.01) * torch.rand(H, generator=g))
    dt = torch.nn.functional.softplus(f(B, S, H))
    x, Bm, Cm, gy = (t.bfloat16().float() for t in (f(B, S, H, P), f(B, S, G, N),
                                                    f(B, S, G, N), f(B, S, H, P)))
    gs = f(B, H, N, P)
    zero = lambda t: torch.zeros_like(t)
    a = _ssd_grads64((x, dt, A, Bm, Cm, gy, zero(gs)), chunk)[2]
    b = _ssd_grads64((x, dt, A, Bm, Cm, zero(gy), gs), chunk)[2]
    gs = (gs * ((rho - 1) * a / b)[None, :, None, None]).float()
    ins = (x, dt, A, Bm, Cm, gy, gs)
    want = _ssd_grads64(ins, chunk)[2]
    assert want.abs().max() < 2 * rho * a.abs().max()
    err = lambda got: (got.double() - want).abs().max().item()
    xs = [t.clone().requires_grad_(True) for t in ins[:5]]
    f32 = err(torch.autograd.grad(ref.ssd_ref(*xs, chunk), xs, (gy, gs))[2])
    hi_lo = err(ref.ssd_bwd_wgmma_emulated(*ins, chunk, n_in=1, n_mid=2, n_state=2)[2])
    three = err(ref.ssd_bwd_wgmma_emulated(*ins, chunk, n_in=1, n_mid=2, n_state=3)[2])
    assert hi_lo > 3 * f32 and three < 2 * f32, (f32, hi_lo, three)


def test_ssd_backward_emulation_with_f32_products_is_the_plain_passes():
    """With exact products (f64 inputs through three pieces hold f32's
    precision) the emulation's passes reproduce ``ref.ssd_bwd_ref``, the
    plain backward the card's CUDA-core body follows, to f32 rounding: the
    tile sweeps compute the same function."""
    ins = _ssd_inputs(7, 1, 130, 2, 64, 1, 64, False)
    t = list(map(torch.from_numpy, ins))
    got = ref.ssd_bwd_wgmma_emulated(*t, 64, n_in=3, n_mid=3)
    want = ref.ssd_bwd_ref(*t, 64)
    for g, w in zip(got, want):
        assert (g - w.float()).abs().max() <= 1e-5 * w.abs().max() + 1e-6

"""The precision argument of the f32 SSD forward's body on the tensor
cores, on the CPU.

At P 64, N 64 or 128 and chunks of 64-256 (every SSM config of the repo)
the f32 ``ssd_scan`` runs three passes on wgmma, every input (x, B, C)
and every f32 intermediate (w x, the carried state_in, the mapped scores
map(S)) entering its products as three bf16 pieces, each product the six
piece pairs i + j <= 2 (``csrc/ssd_scan.cu``).  ``ref.ssd_fwd_wgmma_emulated``
does that arithmetic in torch, pass by pass and in the kernel's order.
Here it is held against the JAX package's Pallas ``ssd_scan`` (interpret
mode) and its oracle ``ssd_ref`` on the same numpy inputs, per element at
``chip_smoke.py``'s f32 limit: (SSD_REL + 8 eps |acs|max) want_abs + 1e-6,
want_abs the oracle on |x|, |B|, |C|.  A small |A| makes that limit
sharp (about 2e-6 of want_abs); with C tied to B the first rows' scores
carry no cancellation, and there the intermediates as hi + lo (two
pieces), or the inputs as bf16 alone, miss it: the gate tells the designs
apart."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro_torch.kernels import ref

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

SSD_REL, F32_EPS = 1e-6, 2.0**-24     # chip_smoke.py's f32 ssd_scan limit


def _inputs(seed, B, S, H, P, G, N, scale, tied):
    """x, dt, A, B, C as chip_smoke.py draws them: x, B, C normal (C equal
    to B where ``tied``), dt softplus of a normal, A < 0 with |A|
    log-uniform in [0.01, 1] times ``scale``."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    A = (-np.exp(np.log(0.01) * rng.rand(H)) * scale).astype(np.float32)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    x, Bm, Cm = f(B, S, H, P), f(B, S, G, N), f(B, S, G, N)
    return x, dt, A, Bm, Bm.copy() if tied else Cm


def _limit(x, dt, A, Bm, Cm, chunk):
    """(want_abs of y, of the final state, the factor of want_abs) of the
    f32 gate."""
    ya, sa = jref.ssd_ref(*map(jnp.asarray, (np.abs(x), dt, A, np.abs(Bm), np.abs(Cm))), chunk)
    S = x.shape[1]
    a = np.pad(dt * A, ((0, 0), (0, (-S) % chunk), (0, 0)))
    acs_max = np.abs(a.reshape(a.shape[0], -1, chunk, a.shape[2])).sum(2).max()
    return np.asarray(ya), np.asarray(sa), SSD_REL + 8 * F32_EPS * float(acs_max)


def _ratio(got, x, dt, A, Bm, Cm, chunk):
    """The worst error / limit of (y, final state) over both JAX versions:
    the Pallas kernel in interpret mode and the oracle."""
    ya, sa, rel = _limit(x, dt, A, Bm, Cm, chunk)
    args = list(map(jnp.asarray, (x, dt, A, Bm, Cm)))
    worst = 0.0
    for want in (jssd_scan(*args, chunk=chunk), jref.ssd_ref(*args, chunk)):
        for g, w, wa in zip(got, want, (ya, sa)):
            err = np.abs(g.numpy().astype(np.float64) - np.asarray(w))
            worst = max(worst, float((err / (rel * wa + 1e-6)).max()))
    return worst


# reduced copies of chip_smoke.py's SSD_CASES at the body's shapes (B, S,
# H, P, G, N, chunk, scale of A, C tied to B): mamba2-130m's heads cut to
# 6 with a full chunk and a ragged one, B 2 with G 2 and S ragged inside a
# 64-row tile, each chunk the body takes (64, 128, 192, 256) at N 64 and
# 128, G 3, S < 64, decays past f32's exp range, and the sharp case
SSD_CASES = [
    (1, 300, 6, 64, 1, 128, 256, 1.0, False),
    (2, 200, 4, 64, 2, 128, 256, 1.0, False),
    (1, 150, 4, 64, 2, 64, 64, 1.0, False),
    (1, 200, 6, 64, 3, 128, 128, 1.0, False),
    (1, 250, 4, 64, 2, 64, 192, 1.0, False),
    (1, 40, 4, 64, 1, 128, 256, 1.0, False),
    (1, 300, 4, 64, 1, 128, 256, 50.0, False),
]
SHARP = (1, 300, 6, 64, 1, 128, 256, 0.01, True)


@pytest.mark.parametrize("case", SSD_CASES + [SHARP], ids=lambda c: "-".join(map(str, c)))
def test_ssd_f32_body_holds_the_f32_gate(case):
    """The emulated body (inputs and intermediates as three pieces) within
    the f32 gate against both JAX versions by a margin (under 1/2: the
    card's own accumulation order must fit in the rest)."""
    *shape, chunk, scale, tied = case
    x = _inputs(sum(shape), *shape, scale, tied)
    got = ref.ssd_fwd_wgmma_emulated(*map(torch.from_numpy, x), chunk, n_in=3, n_mid=3)
    assert _ratio(got, *x, chunk) <= 0.5


@pytest.mark.parametrize("n_in,n_mid", [(3, 2), (1, 3)], ids=["mid-hi-lo", "in-bf16"])
def test_ssd_f32_body_on_fewer_pieces_misses_the_sharp_gate(n_in, n_mid):
    """On the sharp case the intermediates as hi + lo (two pieces) or the
    inputs as bf16 alone (one piece) miss the f32 gate."""
    *shape, chunk, scale, tied = SHARP
    x = _inputs(sum(shape), *shape, scale, tied)
    got = ref.ssd_fwd_wgmma_emulated(*map(torch.from_numpy, x), chunk, n_in=n_in, n_mid=n_mid)
    assert _ratio(got, *x, chunk) > 1.0


def test_ssd_f32_gate_is_sharp_on_the_small_a_case():
    """The small |A| brings the limit near 2e-6 of want_abs (at scale 1 it
    is about 1e-4): the sharp case is what makes the pieces count."""
    for scale, lo, hi in ((0.01, 1.5e-6, 3e-6), (1.0, 5e-5, 2e-4)):
        *shape, chunk, _, tied = SHARP
        x = _inputs(sum(shape), *shape, scale, tied)
        assert lo < _limit(*x, chunk)[2] < hi


def test_ssd_f32_emulation_with_f32_products_is_the_plain_passes():
    """With exact products (three pieces of every operand carry f32's
    precision) the emulation's passes reproduce the plain passes the card
    tests hold each kernel pass to, ``ref.ssd_chunk_states`` ->
    ``ref.ssd_carry`` -> ``ref.ssd_chunk_outputs``, to f32 rounding: the
    tiles and partials compute the same function."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(7, 2, 300, 4, 64, 2, 128, 1.0, False))
    got_y, got_st = ref.ssd_fwd_wgmma_emulated(x, dt, A, Bm, Cm, 128, n_in=3, n_mid=3)
    U, decay = ref.ssd_chunk_states(x, dt, A, Bm, 128)
    states_in, want_st = ref.ssd_carry(U, decay)
    want_y = ref.ssd_chunk_outputs(x, dt, A, Bm, Cm, states_in, 128)
    for g, w in ((got_y, want_y), (got_st, want_st)):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max() + 1e-6

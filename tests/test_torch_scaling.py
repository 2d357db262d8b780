"""The port's memory model (R5) against the JAX package's, and the search
that measures R5 on the card (``chip_smoke.py``'s ``find_max_batch``) on
fake steps.

``MemoryModel`` is the JAX package's arithmetic copied: state, activation
and step bytes and the largest batch that fits must be equal to JAX's for
both BERT sizes and llama3-8b over a grid of parameter bytes, activation
factors, state shards and memory sizes; the JAX benchmark's R5 reading
(``benchmarks/run.py`` ``bench_r5_batch_vs_model``: 117 and 42 on the
H100 NVL) must come out the same.  The search runs on a fake step whose
peak grows with the batch and which raises ``torch.cuda.OutOfMemoryError``
above a threshold."""
import dataclasses
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import scaling as jscaling
from repro_torch.configs import get_config
from repro_torch.core import scaling

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("bert-mlm-120m", "bert-mlm-350m", "llama3-8b")
GRID = list(itertools.product((2, 4), (14.0, 150.0), (1, 8), (16e9, 80e9, 94e9)))


def test_h100_nvl_is_the_jax_description():
    assert dataclasses.asdict(scaling.H100_NVL) == dataclasses.asdict(jscaling.H100_NVL)


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_model_defaults_match_jax(arch):
    t, j = scaling.MemoryModel(get_config(arch)), jscaling.MemoryModel(jget_config(arch))
    assert (t.param_bytes, t.opt_bytes, t.act_factor, t.state_shards) == \
        (j.param_bytes, j.opt_bytes, j.act_factor, j.state_shards)
    assert t.state_bytes() == j.state_bytes()
    assert t.max_batch(512, 94e9) == j.max_batch(512, 94e9)


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_model_matches_jax_over_the_grid(arch):
    """state_bytes, act_bytes and step_bytes at three batch and sequence
    sizes, and max_batch at two sequence lengths and two reserves, for
    every (param_bytes, act_factor, state_shards, hbm) of the grid."""
    tcfg, jcfg = get_config(arch), jget_config(arch)
    for pb, af, shards, hbm in GRID:
        kw = dict(param_bytes=pb, act_factor=af, state_shards=shards)
        t, j = scaling.MemoryModel(tcfg, **kw), jscaling.MemoryModel(jcfg, **kw)
        assert t.state_bytes() == j.state_bytes()
        for b, s in ((1, 512), (20, 512), (3, 8192)):
            assert t.act_bytes(b, s) == j.act_bytes(b, s)
            assert t.step_bytes(b, s) == j.step_bytes(b, s)
        for seq, reserve in itertools.product((512, 8192), (0.10, 0.0)):
            assert t.max_batch(seq, hbm, reserve) == j.max_batch(seq, hbm, reserve), \
                (pb, af, shards, hbm, seq, reserve)


def test_bench_r5_reading_is_reproduced():
    """The JAX benchmark's R5 model reading: act_factor 150, bf16
    parameters, S 512 on the H100 NVL's 94 GB: 117 and 42 (the paper
    measured 184 and 20)."""
    got = [scaling.MemoryModel(get_config(a), act_factor=150.0).max_batch(
        512, scaling.H100_NVL.hbm_bytes) for a in ("bert-mlm-120m", "bert-mlm-350m")]
    assert got == [117, 42]
    assert got == [jscaling.MemoryModel(jget_config(a), act_factor=150.0).max_batch(
        512, jscaling.H100_NVL.hbm_bytes) for a in ("bert-mlm-120m", "bert-mlm-350m")]


def test_a_model_that_does_not_fit_gets_batch_zero():
    mm = scaling.MemoryModel(get_config("llama3-8b"), param_bytes=4)
    assert mm.max_batch(8192, 80e9) == 0
    assert mm.max_batch(8192, 80e9) == jscaling.MemoryModel(
        jget_config("llama3-8b"), param_bytes=4).max_batch(8192, 80e9)


# ---------------------------------------------------------------------------
# the search of the largest batch that fits, on fake steps
# ---------------------------------------------------------------------------

CAPACITY = 79e9


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


find_max_batch = _chip_smoke().find_max_batch


def fake_step(threshold, base=3e9, per=35e6, curve=0.0, tried=None):
    """A step whose peak is base + per B + curve B^2 bytes and which runs
    out of memory above ``threshold`` samples."""
    def step(b):
        if tried is not None:
            tried.append(b)
        if b > threshold:
            raise torch.cuda.OutOfMemoryError(f"fake: B {b} > {threshold}")
        return base + per * b + curve * b * b
    return step


def _line_limit(base=3e9, per=35e6):
    return (CAPACITY - base) / per


@pytest.mark.parametrize("where", [1.0, 0.99, 0.97, 0.93, 0.91])
def test_search_returns_the_thresholds_bracket(where):
    """A linear peak and the threshold where the small batches' line meets
    the capacity, or up to 9% below it (the allocator's fragmentation):
    the search returns fit <= threshold < oom with oom within 3% of fit,
    in at most four tries after the two small ones."""
    threshold = int(_line_limit() * where)
    tried = []
    got = find_max_batch(fake_step(threshold, tried=tried), (32, 64), CAPACITY)
    assert got["fit"] <= threshold < got["oom"] <= got["fit"] * 1.03
    assert tried[:2] == [32, 64] and len(tried) <= 6
    assert [b for b, _ in got["tries"]] == tried
    np.testing.assert_allclose(got["line"], (3e9, 35e6))


@pytest.mark.parametrize("curve", [2e3, -1e3, -2e3])
def test_search_follows_a_peak_that_curves_away_from_the_line(curve):
    """A peak that grows faster than the small batches' line (the loss
    chunk's logits once its length is clamped) or slower: the threshold
    is where the peak meets the capacity, up to 20% above the line's
    reading, and the line through the two largest fits is refitted after
    each fit."""
    peak = lambda b: 3e9 + 35e6 * b + curve * b * b
    threshold = max(b for b in range(1, 4000) if peak(b) <= CAPACITY)
    got = find_max_batch(fake_step(threshold, curve=curve), (32, 64), CAPACITY)
    assert got["fit"] <= threshold < got["oom"] <= got["fit"] * 1.03
    assert len(got["tries"]) <= 6


def test_search_fails_when_no_try_runs_out_of_memory():
    with pytest.raises(RuntimeError, match="no bracket"):
        find_max_batch(fake_step(10**9), (32, 64), CAPACITY)


@pytest.mark.parametrize("threshold", [16, 40])
def test_search_fails_when_a_small_batch_runs_out_of_memory(threshold):
    with pytest.raises(RuntimeError, match="small batch"):
        find_max_batch(fake_step(threshold), (32, 64), CAPACITY)


def test_search_passes_any_other_error_on():
    def step(b):
        if b > 64:
            raise ValueError("not a memory error")
        return 3e9 + 35e6 * b
    with pytest.raises(ValueError):
        find_max_batch(step, (32, 64), CAPACITY)

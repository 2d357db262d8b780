"""Gradient accumulation with bf16 parameters (ROADMAP C12) against the
JAX package on the CPU: the microbatch gradients of a bf16 parameter are
summed in f32 and scaled once, as the JAX ``accumulate_grads`` sums them
into f32 zeros, and that f32 sum is what AdamW and the gradient sync
receive.  Checked in one process and on two gloo ranks (bucketed
all-reduce from the final microbatch's hooks, and the fused fallback),
on the small bert-mlm-120m of ``tests/test_torch_ddp.py`` (d 64, vocab
256, S 32, B 8) with bf16 parameters, in bf16 activations and, where
the comparison with JAX is sharp enough to see the accumulation, in f32
activations."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.accum import accumulate_grads as jaccumulate
from repro.models import build_model as jbuild_model
from repro.train import train_step as jts
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.accum import accumulate_grads
from repro_torch.models.model import build_model
from repro_torch.models.params import flatten_tree
from repro_torch.train import train_step as tts
from repro_torch.train.optimizer import AdamWConfig

from test_torch_ddp import spawn_ranks

torch.set_num_threads(2)

B, S, V = 8, 32, 256
# the f32 sum of the same bf16 microbatch gradients, added in another
# order (at most 8 terms): a few f32 roundings of the leaf's scale
F32_SUM_REL = 1e-6
# port against JAX, both in bf16 activations: the two frameworks round
# their bf16 activations and products at other places, so single
# elements differ by a few bf16 roundings (2^-8) of the leaf's scale;
# measured at most 4.3e-2 of a leaf's max at microbatch 1, where no
# accumulation is involved, hence 2^-4
JAX_BF16_REL = 2.0**-4
# the key bias's exact gradient is 0 (the softmax is shift-invariant):
# both packages return rounding noise there, held to 0 at the scale of
# the key projection's gradient (as in tests/test_torch_train.py)
ZERO_GRAD = {"groups.0.0.mixer.bk": "groups.0.0.mixer.wk"}
# port against JAX with bf16 parameters and f32 activations.  The
# accumulators depend only on the parameters' dtype, and in f32
# activations each microbatch gradient of a bf16 leaf is the f32 vjp
# rounded to bf16, in both packages alike; JAX is compiled without XLA's
# excess precision (``JAX_EXACT_BF16``), which would otherwise keep those
# gradients in f32 inside its scan, one bf16 rounding of each term away
# from what its code says.  The two then differ only where an element's
# f32 gradient lies so close to a bf16 rounding boundary that the two
# packages round it apart: a rare element, by at most about one bf16 step
# of its leaf (2^-8 of the leaf's max; measured at most 1.8e-3 at
# microbatch 1 to 8).  Every other element agrees to f32 rounding
# (F32_APART).  At most FLIP_SHARE of all gradient elements may lie
# further apart than that: measured 0.09%, 0.15% and 0.19% at microbatch
# 2, 4 and 8 (8: the bucketed ranks' one-process count), against 55%, 80%
# and 89% for a bf16 accumulation (each microbatch's bf16 gradient added
# into the bf16 sum), which ``test_flip_share_rejects_a_bf16_accumulation``
# holds to failing (at microbatch 4 it also exceeds ONE_FLIP_REL: 4.3e-3).
ONE_FLIP_REL = 2.0**-8
F32_APART = 1e-5
FLIP_SHARE = 0.01
JAX_EXACT_BF16 = {"xla_allow_excess_precision": False}
# two ranks: bucketed at microbatch 2 and 4 (local batch 4), and the
# fused fallback (overlap off) at the same counts, each in bf16 and in
# f32 activations
DDP_CASES = {"bucketed_micro2": (2, True, "bfloat16"), "bucketed_micro4": (4, True, "bfloat16"),
             "fused_micro2": (2, False, "bfloat16"), "fused_micro4": (4, False, "bfloat16"),
             "bucketed_micro2_f32act": (2, True, "float32"),
             "bucketed_micro4_f32act": (4, True, "float32"),
             "fused_micro2_f32act": (2, False, "float32"),
             "fused_micro4_f32act": (4, False, "float32")}


def _cfgs():
    jcfg = dataclasses.replace(jreduced(jget_config("bert-mlm-120m"), d_model=64),
                               vocab_size=V, max_position=S)
    tcfg = dataclasses.replace(reduced(get_config("bert-mlm-120m"), d_model=64),
                               vocab_size=V, max_position=S)
    return jcfg, tcfg


def _runs(jcfg, tcfg, micro, act="bfloat16"):
    kw = dict(sharding="ddp", param_dtype="bfloat16", activation_dtype=act,
              microbatch=micro)
    return (JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, "train"), **kw),
            RunConfig(model=tcfg, shape=ShapeConfig("t", S, B, "train"), **kw))


def _batch():
    rng = np.random.RandomState(1)
    toks = rng.randint(4, V, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "loss_mask": np.ones((B, S), np.float32)}


def _tbatch(b, rows=slice(None)):
    return {k: torch.from_numpy(v[rows]).long() if v.dtype == np.int32 else
            torch.from_numpy(v[rows]) for k, v in b.items()}


@pytest.fixture(scope="module")
def models():
    """One JAX-initialised f32 parameter set, carried into the port; both
    round it to bf16 (to nearest even) for the runs."""
    jcfg, tcfg = _cfgs()
    jmodel = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(np.array, jmodel.init(jax.random.PRNGKey(0)))
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_jax_params(params)
    return jcfg, jmodel, params, tmodel


def _jax_grads(models, micro, act="bfloat16"):
    """JAX ``accumulate_grads`` on the bf16-rounded parameters; in f32
    activations compiled with ``JAX_EXACT_BF16``."""
    jcfg, jmodel, params, tmodel = models
    jrun, _ = _runs(jcfg, tmodel.cfg, micro, act)
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    acc = lambda p, b: jaccumulate(lambda pp, bb: jts.loss_for(jmodel, pp, bb, run=jrun),
                                   p, b, micro)[1]
    if act == "bfloat16":
        grads = acc(p16, batch)
    else:
        grads = jax.jit(acc).lower(p16, batch).compile(compiler_options=JAX_EXACT_BF16)(p16, batch)
    return flatten_tree(jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads))


def _close(got, want, rel, zero=()):
    """Per leaf: |got - want| <= rel * max|want|; a leaf of ``zero``
    (ZERO_GRAD), whose exact gradient is 0, within rel of its reference
    leaf's scale on both sides."""
    for k, w in want.items():
        g = got[k]
        if k in zero:
            lim = rel * float(np.abs(want[ZERO_GRAD[k]]).max())
            assert max(np.abs(g).max(), np.abs(w).max()) <= lim, (k, lim)
            continue
        lim = rel * float(np.abs(w).max()) + 1e-12
        err = float(np.abs(g - w).max())
        assert err <= lim, (k, err, lim)


def _apart(got, want):
    """(the largest |got - want| of a leaf over its max, the share of all
    elements further apart than F32_APART of their leaf's max); the key
    bias, whose exact gradient is 0, at wk's scale."""
    worst, far, total = 0.0, 0, 0
    for k, w in want.items():
        scale = float(np.abs(want[ZERO_GRAD.get(k, k)]).max())
        err = np.abs(got[k] - w)
        worst = max(worst, float(err.max()) / scale)
        far += int((err > F32_APART * scale).sum())
        total += err.size
    return worst, far / total


def _close_but_for_flips(got, want):
    worst, share = _apart(got, want)
    assert worst <= ONE_FLIP_REL and share <= FLIP_SHARE, (worst, share)


def _port_grads(tmodel, run, micro, rows=slice(None)):
    state = tts.init_state(tmodel, run, seed=None)
    _, grads, _ = accumulate_grads(lambda p, bb: tts.loss_for(tmodel, p, bb, run=run),
                                   state["params"], _tbatch(_batch(), rows), micro)
    return grads


@pytest.mark.parametrize("micro", [2, 4])
def test_bf16_microbatch_grads_are_the_f32_sum(models, micro):
    """Every accumulated gradient is f32 and equals the f32 sum of the
    same microbatches' own bf16 gradients, scaled once: the accumulation
    adds no rounding of its own (before the repair it rounded each sum to
    bf16, 6e-3 of a leaf's scale away)."""
    jcfg, _, _, tmodel = models
    _, run = _runs(jcfg, tmodel.cfg, micro)
    grads = _port_grads(tmodel, run, micro)
    assert {g.dtype for g in grads.values()} == {torch.float32}
    k = B // micro
    want = {}
    for i in range(micro):
        one = _port_grads(tmodel, dataclasses.replace(run, microbatch=1), 1,
                          slice(i * k, (i + 1) * k))
        assert {g.dtype for g in one.values()} == {torch.bfloat16}
        for name, g in one.items():
            want[name] = want.get(name, 0) + g.float()
    _close({n: g.numpy() for n, g in grads.items()},
           {n: (w / micro).numpy() for n, w in want.items()}, F32_SUM_REL)


@pytest.mark.parametrize("micro", [1, 2, 4])
def test_bf16_accumulation_matches_jax(models, micro):
    jcfg, _, _, tmodel = models
    _, run = _runs(jcfg, tmodel.cfg, micro)
    got = {n: g.float().numpy() for n, g in _port_grads(tmodel, run, micro).items()}
    want = _jax_grads(models, micro)
    assert sorted(got) == sorted(want)
    _close(got, want, JAX_BF16_REL, ZERO_GRAD)


@pytest.mark.parametrize("micro", [2, 4])
def test_bf16_accumulation_with_f32_activations_matches_jax(models, micro):
    """bf16 parameters, f32 activations: the port's f32 sums against JAX
    ``accumulate_grads`` element for element, all but FLIP_SHARE of them
    to f32 rounding."""
    jcfg, _, _, tmodel = models
    _, run = _runs(jcfg, tmodel.cfg, micro, "float32")
    grads = _port_grads(tmodel, run, micro)
    assert {g.dtype for g in grads.values()} == {torch.float32}
    got = {n: g.numpy() for n, g in grads.items()}
    want = _jax_grads(models, micro, "float32")
    assert sorted(got) == sorted(want)
    _close_but_for_flips(got, want)


@pytest.mark.parametrize("micro", [2, 4])
def test_flip_share_rejects_a_bf16_accumulation(models, micro):
    """The same comparison fails for the fault it guards against: the
    port's own bf16 microbatch gradients added into a bf16 sum, as before
    the repair, lie apart from JAX on far more than FLIP_SHARE of the
    elements."""
    jcfg, _, _, tmodel = models
    _, run = _runs(jcfg, tmodel.cfg, 1, "float32")
    k = B // micro
    acc = {}
    for i in range(micro):
        one = _port_grads(tmodel, run, 1, slice(i * k, (i + 1) * k))
        for name, g in one.items():
            assert g.dtype == torch.bfloat16
            acc[name] = g.clone() if name not in acc else acc[name] + g
    got = {n: (g / micro).float().numpy() for n, g in acc.items()}
    assert _apart(got, _jax_grads(models, micro, "float32"))[1] > 20 * FLIP_SHARE


def test_the_step_hands_adamw_f32_gradients(models, monkeypatch):
    jcfg, _, _, tmodel = models
    _, run = _runs(jcfg, tmodel.cfg, 2)
    seen = []

    def spy(c, grads, opt_state, params):
        seen.append({g.dtype for g in grads.values()})
        return real(c, grads, opt_state, params)

    real = tts.adamw_update
    monkeypatch.setattr(tts, "adamw_update", spy)
    state = tts.init_state(tmodel, run, seed=None)
    step = tts.make_train_step(tmodel, run, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2))
    state, m = step(state, _tbatch(_batch()))
    assert seen == [{torch.float32}] and np.isfinite(m["loss"].item())
    assert all(p.dtype == torch.bfloat16 and p.grad is None
               for p in state["params"].parameters())


# ---------------------------------------------------------------------------
# two ranks on gloo
# ---------------------------------------------------------------------------

WORKER = """
    import dataclasses, json, sys, numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed import maybe_initialize_distributed
    from repro_torch.distributed.sharding import ParallelPlan
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import init_state, make_grad_fn

    ref, out, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    info = maybe_initialize_distributed('cpu')
    B, S, V = 8, 32, 256
    cfg = dataclasses.replace(reduced(get_config('bert-mlm-120m'), d_model=64),
                              vocab_size=V, max_position=S)
    z = np.load(ref)
    model = build_model(cfg, device='cpu')
    model.load_jax_params({k[6:]: z[k] for k in z.files if k.startswith('param/')})
    rows = slice(info.rank * 4, (info.rank + 1) * 4)
    batch = {'tokens': torch.from_numpy(z['tokens'][rows]).long(),
             'labels': torch.from_numpy(z['labels'][rows]).long(),
             'loss_mask': torch.from_numpy(z['loss_mask'][rows])}
    save = {}
    for case, (micro, overlap, act) in cases.items():
        run = RunConfig(model=cfg, shape=ShapeConfig('t', S, B, 'train'), sharding='ddp',
                        param_dtype='bfloat16', activation_dtype=act, microbatch=micro)
        plan = ParallelPlan.for_run(run, info.world, grad_bucket_mb=0.05, overlap=overlap)
        save[case + '/grad_sync'] = np.asarray(plan.grad_sync)
        params = init_state(model, run, seed=None)['params']
        loss, grads, met = make_grad_fn(model, run, plan)(params, batch)
        save[case + '/dtypes'] = np.asarray(sorted({str(g.dtype) for g in grads.values()}))
        for k, g in grads.items():
            save[case + '/grad/' + k] = g.float().numpy().copy()
    np.savez(out, **save)
    torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("accum_ddp")
    _, _, params, _ = models
    ref = tmp / "params.npz"
    np.savez(ref, **_batch(), **{"param/" + k: a for k, a in flatten_tree(params).items()})
    spawn_ranks(tmp, WORKER, [str(ref), str(tmp / "rank{rank}.npz"), json.dumps(DDP_CASES)])
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("case", list(DDP_CASES))
def test_two_ranks_reduce_the_f32_sums(models, ranks, case):
    """Each rank's gradients are f32 and equal one process's f32 sum of the
    same microbatches to f32 rounding: the bucketed ranks split their 4
    rows into ``micro`` microbatches, which is one process at ``2 micro``;
    the fused fallback splits the global batch, which is one process at
    ``micro``.  Both also match JAX ``accumulate_grads``: in bf16
    activations at the bf16 bar, in f32 activations all but FLIP_SHARE of
    the elements to f32 rounding."""
    jcfg, _, _, tmodel = models
    micro, overlap, act = DDP_CASES[case]
    one_micro = 2 * micro if overlap else micro
    _, run = _runs(jcfg, tmodel.cfg, one_micro, act)
    one = {n: g.numpy() for n, g in _port_grads(tmodel, run, one_micro).items()}
    want_jax = _jax_grads(models, one_micro, act)
    for r in ranks:
        assert str(r[case + "/grad_sync"]) == ("bucketed_overlap" if overlap else "xla_fused")
        assert list(r[case + "/dtypes"]) == ["torch.float32"]
        got = {k[len(case) + 6:]: v for k, v in r.items() if k.startswith(case + "/grad/")}
        assert sorted(got) == sorted(one)
        _close(got, one, F32_SUM_REL)
        if act == "bfloat16":
            _close(got, want_jax, JAX_BF16_REL, ZERO_GRAD)
        else:
            _close_but_for_flips(got, want_jax)

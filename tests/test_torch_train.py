"""The port's MLM training of bert-mlm-120m against the JAX package on the
CPU, in f32, on the same parameters and the same fixed masked batches:
the encoder forward and MLM head, ``loss_for`` and every gradient leaf,
the chunked loss, AdamW, 20-step loss trajectories (with and without
microbatches), the runner, and the pieces MFU needs.  ``jax.random`` and
``torch.Generator`` draw different bits, so masks and batches are made
with numpy and handed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import uniform_schedule as juniform
from repro.core import scaling as jscaling
from repro.core.accum import accumulate_grads as jaccumulate
from repro.models import build_model as jbuild_model
from repro.models.transformer import head_apply as jhead_apply
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import LayerSpec, RunConfig, ShapeConfig, uniform_schedule
from repro_torch.core import scaling
from repro_torch.core.accum import accumulate_grads
from repro_torch.core.mlm import lm_loss, mask_tokens, mlm_loss
from repro_torch.distributed.sharding import ParallelPlan
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.models.params import flatten_tree
from repro_torch.models.transformer import head_apply
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts
from repro_torch.train.runner import AsyncMetrics, StepRunner, TrainLoop
from repro_torch.train.trainer import train

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

B, S = 4, 48
HIDDEN_TOL = dict(atol=1e-4, rtol=1e-5)   # f32; the two frameworks sum in other orders
LEAF_REL, LEAF_FLOOR = 1e-5, 1e-8         # |g - g_jax| <= 1e-5 max|g_jax| + 1e-8, per leaf
TRAJ_REL = 1e-5                           # ROADMAP A3's bar, per step


def _cfgs(n_layers=2):
    jcfg = dataclasses.replace(jreduced(jget_config("bert-mlm-120m")),
                               schedule=juniform(n_layers, JLayerSpec()))
    tcfg = dataclasses.replace(reduced(get_config("bert-mlm-120m")),
                               schedule=uniform_schedule(n_layers, LayerSpec()))
    return jcfg, tcfg


def _runs(jcfg, tcfg, **kw):
    kw = dict(sharding="ddp", param_dtype="float32", activation_dtype="float32", **kw)
    return (JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, "train"), **kw),
            RunConfig(model=tcfg, shape=ShapeConfig("t", S, B, "train"), **kw))


def _batch(seed, vocab, mask_id=3):
    """Random tokens masked with the BERT recipe, in numpy."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (B, S)).astype(np.int32)
    sel = (rng.rand(B, S) < 0.15) & (toks >= 4)
    r = rng.rand(B, S)
    inputs = np.where(sel & (r < 0.8), mask_id, toks)
    inputs = np.where(sel & (r >= 0.8) & (r < 0.9), rng.randint(4, vocab, (B, S)), inputs)
    return {"tokens": inputs.astype(np.int32), "labels": toks,
            "loss_mask": sel.astype(np.float32)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.fixture(scope="module")
def models():
    """One JAX-initialised parameter set in both packages.  Biases and
    norm parameters are re-drawn (JAX inits them to 0 / 1) so that every
    leaf carries information."""
    jcfg, tcfg = _cfgs()
    jmodel = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(np.array, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    for path, a in flatten_tree(params).items():
        if path.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "bi", "bo", "bias", "scale",
                                       "out_bias"):
            a[...] = (1.0 if path.endswith("scale") else 0.0) \
                + 0.1 * rng.standard_normal(a.shape)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_jax_params(params)
    return jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel


def _leaf_err(got, want):
    """Largest error over the leaf's limit (passes at <= 1)."""
    return float(np.abs(got - want).max()) / (LEAF_REL * float(np.abs(want).max()) + LEAF_FLOOR)


# The key bias's exact gradient is 0: it adds q.bk to every score of a
# row, and the softmax is invariant to that shift.  Both packages return
# f32 rounding noise there (~1e-8), which no relative bound can compare;
# it is held to zero at the scale of the key projection's gradient.
ZERO_GRAD = {"groups.0.0.mixer.bk": "groups.0.0.mixer.wk"}


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def test_mlm_leaves_carry_over(models):
    jcfg, jmodel, params, tmodel = models
    sd = tmodel.state_dict()
    assert {"mlm.dense", "mlm.bias", "mlm.ln.scale", "mlm.ln.bias", "mlm.out_bias",
            "embed.positions"} <= set(sd)
    for k, a in flatten_tree(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)
    assert not any(p.requires_grad for p in tmodel.parameters())   # frozen until init_state


def test_encoder_hidden_and_mlm_logits_match_jax(models):
    jcfg, jmodel, params, tmodel = models
    b = _batch(1, jcfg.vocab_size)
    jh, _, _ = jmodel.apply(params, _jbatch(b), mode="train", return_hidden=True)
    jlogits = jhead_apply(params, jh, jcfg)
    with torch.no_grad():
        th, _, _ = tmodel.apply(_tbatch(b), mode="train", return_hidden=True)
        tlogits = head_apply(tmodel, th, tmodel.cfg)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HIDDEN_TOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **HIDDEN_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_chunked_xent_matches_jax(models, use_pallas):
    """Several chunks and a padded last one (S = 48, chunk 10); the JAX
    side with its Pallas xent in interpret mode or its jnp analogue."""
    jcfg, jmodel, params, tmodel = models
    b = _batch(2, jcfg.vocab_size)
    h = np.random.RandomState(3).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    want = jts.chunked_xent(params, jnp.asarray(h), jnp.asarray(b["labels"]),
                            jnp.asarray(b["loss_mask"]), jcfg, chunk=10,
                            use_pallas=use_pallas)
    jgrad = jax.grad(lambda x: jts.chunked_xent(
        params, x, jnp.asarray(b["labels"]), jnp.asarray(b["loss_mask"]), jcfg,
        chunk=10)[0])(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    got = tts.chunked_xent(tmodel, th, torch.from_numpy(b["labels"]).long(),
                           torch.from_numpy(b["loss_mask"]), tmodel.cfg, chunk=10)
    got[0].backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    assert _leaf_err(th.grad.numpy(), np.asarray(jgrad)) <= 1.0


@pytest.mark.parametrize("G,seq,V,shards", [(32, 512, 32768, 1), (8, 64, 1024, 1),
                                            (256, 4096, 256000, 8), (1, 8, 50, 1)])
def test_loss_chunk_len_matches_jax(G, seq, V, shards):
    assert tts.loss_chunk_len(G, seq, V, shards) == jts.loss_chunk_len(G, seq, V, shards)


# ---------------------------------------------------------------------------
# loss, gradients, trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatch", [1, 2])
def test_loss_and_every_grad_leaf_match_jax(models, microbatch):
    jcfg, jmodel, params, tmodel = models
    jrun, trun = _runs(jcfg, tmodel.cfg, microbatch=microbatch)
    b = _batch(4, jcfg.vocab_size)
    jloss, jgrads, jmet = jaccumulate(
        lambda p, bb: jts.loss_for(jmodel, p, bb, run=jrun), params, _jbatch(b),
        microbatch)
    state = tts.init_state(tmodel, trun, seed=None)
    tloss, tgrads, tmet = accumulate_grads(
        lambda p, bb: tts.loss_for(tmodel, p, bb, run=trun), state["params"],
        _tbatch(b), microbatch)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k in ("xent", "acc", "tokens", "aux_loss", "loss"):
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    jflat = flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(tgrads)
    worst = {k: _leaf_err(tgrads[k].numpy(), jflat[k]) for k in jflat if k not in ZERO_GRAD}
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    for k, ref in ZERO_GRAD.items():
        lim = LEAF_REL * float(np.abs(jflat[ref]).max())
        assert float(np.abs(jflat[k]).max()) <= lim and tgrads[k].abs().max().item() <= lim


def _trajectories(models, n_steps, microbatch):
    """Losses of both packages' train steps on the same 20 batches.  At
    lr 1e-3 the loss falls from 53 to 25; at 2e-3 this small model's
    loss rises again at several steps, and there the two frameworks' f32
    rounding differences (1e-7 relative over the first five steps) grow
    to 4e-5 by step 20."""
    jcfg, jmodel, params, tmodel = models
    jrun, trun = _runs(jcfg, tmodel.cfg, microbatch=microbatch)
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=n_steps, weight_decay=0.1)
    jstep = jax.jit(jts.make_train_step(jmodel, jrun, joptim.AdamWConfig(**opt)))
    tstep = tts.make_train_step(tmodel, trun, toptim.AdamWConfig(**opt))
    jstate = {"params": params, "opt": joptim.init_opt_state(params)}
    tstate = tts.init_state(tmodel, trun, seed=None)
    jl, tl = [], []
    for i in range(n_steps):
        b = _batch(100 + i, jcfg.vocab_size)
        jstate, jm = jstep(jstate, _jbatch(b))
        tstate, tm = tstep(tstate, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        # the gradient norm is more sensitive than the loss: 1e-4
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
    return np.array(jl), np.array(tl)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_20_step_trajectory_matches_jax(models, microbatch):
    jl, tl = _trajectories(models, 20, microbatch)
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _opt_tree(seed, gscale):
    rng = np.random.RandomState(seed)
    shapes = {"w": (3, 4), "stack_scale": (2, 5), "stack_bias": (2, 3, 4), "b": (5,),
              "s": (7,)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (gscale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    return p, g


@pytest.mark.parametrize("clip,gscale", [(1.0, 3.0), (1.0, 0.01), (0.0, 3.0)])
def test_adamw_matches_jax_over_steps(clip, gscale):
    """Three steps of clip, decay mask (ndim >= 2, stacked 1-d leaves
    included), bias correction and schedule against the JAX update."""
    c = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=clip, weight_decay=0.1)
    jc, tc = joptim.AdamWConfig(**c), toptim.AdamWConfig(**c)
    p, _ = _opt_tree(0, gscale)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts_ = joptim.init_opt_state(jp), toptim.init_opt_state(tp)
    for step in range(3):
        _, g = _opt_tree(step + 1, gscale)
        jp, js, jm = joptim.adamw_update(jc, {k: jnp.asarray(v) for k, v in g.items()},
                                         js, jp)
        tp, ts_, tm = toptim.adamw_update(tc, {k: torch.from_numpy(v) for k, v in g.items()},
                                          ts_, tp)
        # the same f32 formulas, rounded in other orders: a few ulp of
        # each leaf's scale
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            for m in ("mu", "nu"):
                scale = float(np.abs(np.asarray(js[m][k])).max())
                np.testing.assert_allclose(ts_[m][k].numpy(), np.asarray(js[m][k]),
                                           rtol=1e-6, atol=1e-6 * scale, err_msg=m + k)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6)
    assert int(ts_["step"]) == int(js["step"]) == 3


def test_weight_decay_mask_is_the_jax_rule():
    """Zero gradients: only leaves with ndim >= 2 move, in both packages,
    which includes the stacked (layers, d) norm leaves."""
    c = dict(lr=1e-2, weight_decay=0.1, grad_clip=0.0, warmup_steps=1, total_steps=10,
             min_lr_ratio=1.0)
    p = {"w": np.ones((2, 2), np.float32), "stack_scale": np.ones((3, 2), np.float32),
         "b": np.ones((2,), np.float32)}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tp, _, _ = toptim.adamw_update(toptim.AdamWConfig(**c),
                                   {k: torch.zeros_like(v) for k, v in tp.items()},
                                   toptim.init_opt_state(tp), tp)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp, _, _ = joptim.adamw_update(joptim.AdamWConfig(**c),
                                   {k: jnp.zeros_like(v) for k, v in jp.items()},
                                   joptim.init_opt_state(jp), jp)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-7)
    assert float(tp["w"][0, 0]) < 1.0 and float(tp["stack_scale"][0, 0]) < 1.0
    assert float(tp["b"][0]) == 1.0


def test_lr_schedule_matches_jax():
    c = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in (0, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            toptim.lr_at(toptim.AdamWConfig(**c), step).item(),
            float(joptim.lr_at(joptim.AdamWConfig(**c), step)), rtol=1e-6, err_msg=step)


# ---------------------------------------------------------------------------
# MLM objective, scaling
# ---------------------------------------------------------------------------


def test_mask_tokens_recipe():
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 1000, (64, 256)))
    a = mask_tokens(torch.Generator().manual_seed(5), toks, 1000, mask_id=3)
    b = mask_tokens(torch.Generator().manual_seed(5), toks, 1000, mask_id=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    inputs, labels, mask = a
    assert torch.equal(labels, toks) and mask.dtype == torch.float32
    sel = mask.bool()
    assert not sel[toks < 4].any()                     # specials never masked
    assert abs(sel.float().mean().item() / (toks >= 4).float().mean().item() - 0.15) < 0.01
    assert torch.equal(inputs[~sel], toks[~sel])
    frac = [(inputs[sel] == 3).float().mean().item(), (inputs[sel] == toks[sel]).float().mean().item()]
    assert abs(frac[0] - 0.8) < 0.03 and abs(frac[1] - 0.1) < 0.03 + 0.001


def test_mlm_and_lm_loss_match_jax():
    from repro.core import mlm as jmlm

    rng = np.random.RandomState(6)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32)
    labels = rng.randint(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.rand(2, 9) < 0.4).astype(np.float32)
    jl, jm = jmlm.mlm_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    tl, tm = mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                      torch.from_numpy(mask))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6, err_msg=k)
    jl, _ = jmlm.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    tl, _ = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels).long())
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)


@pytest.mark.parametrize("arch", ["bert-mlm-120m", "starcoder2-3b"])
def test_param_count_and_model_flops_match_jax(arch):
    assert scaling.param_count(get_config(arch)) == jscaling.param_count(jget_config(arch))
    assert scaling.model_flops(get_config(arch), 16384) == \
        jscaling.model_flops(jget_config(arch), 16384)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def _tiny():
    _, tcfg = _cfgs(1)
    tcfg = dataclasses.replace(tcfg, d_model=64, head_dim=64, n_heads=1, n_kv_heads=1,
                               d_ff=128, vocab_size=128)
    run = RunConfig(model=tcfg, shape=ShapeConfig("t", 16, 4, "train"), sharding="ddp",
                    param_dtype="float32", activation_dtype="float32")
    opt = toptim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    return build_model(tcfg, device="cpu"), run, opt


def _tiny_batches(n, vocab=128):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        toks = torch.from_numpy(rng.randint(4, vocab, (4, 16)))
        inputs, labels, mask = mask_tokens(torch.Generator().manual_seed(len(out)), toks,
                                           vocab, mask_id=3)
        out.append({"tokens": inputs, "labels": labels, "loss_mask": mask})
    return out


def test_trainer_matches_plain_step_loop():
    model, run, opt = _tiny()
    batches = _tiny_batches(7)
    ops.reset_launch_counts()
    state, log = train(model, run, opt, iter(batches), steps=7, log_every=1, seed=3)
    step = tts.make_train_step(model, run, opt)
    ref = tts.init_state(model, run, seed=3)
    want = []
    for b in batches:
        ref, m = step(ref, b)
        want.append(m["loss"].item())
    assert log.steps == list(range(1, 8))
    np.testing.assert_array_equal([m["loss"] for m in log.metrics], want)
    assert want[-1] < want[0]
    for k in ("step_time_ema", "tokens_per_s", "stall_fraction", "host_blocked_s",
              "drain_s", "total_s", "step_time_p50", "forced_metric_resolves"):
        assert k in log.telemetry, k
    assert len(log.mfu) == len(log.tokens_per_s) == 7 and len(log.step_times) == 7
    sd, rd = state["params"].state_dict(), ref["params"].state_dict()
    assert all(torch.equal(sd[k], rd[k]) for k in sd)
    assert not ops.launch_counts          # the CPU path launches no kernel


def test_runner_unported_options_raise():
    model, run, opt = _tiny()
    runner = StepRunner(model, run, opt)
    for kw in ({"journal": object()}, {"straggler_every": 3}):
        with pytest.raises(NotImplementedError, match="A12"):
            TrainLoop(runner, **kw)
    with pytest.raises(NotImplementedError, match="A11"):
        StepRunner(model, run, opt, plan=ParallelPlan.make(2, "fsdp_tp", run.shape.global_batch))


def test_async_metrics_keeps_push_order_and_bounds_the_window():
    am = AsyncMetrics(max_pending=2)
    for i in range(5):
        am.push({"step": i}, {"loss": torch.tensor(float(i))})
    got = am.poll() + am.drain()
    assert [meta["step"] for meta, _ in got] == list(range(5))
    assert [m["loss"] for _, m in got] == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_mfu_uses_model_flops_and_h100_peak():
    model, run, opt = _tiny()
    runner = StepRunner(model, run, opt)
    want = scaling.model_flops(model.cfg, 64) / (0.5 * 989e12)
    assert runner.mfu(0.5, 64) == pytest.approx(want)

"""The port's data-parallel training (ddp) against the JAX package on the
CPU: the bucket plan leaf for leaf, the plan's strategy table, and two
ranks on gloo (two processes on a file store) against the port's one
process and against the JAX ``make_grad_fn`` on a 2-device mesh, on the
reduced bert-mlm-120m of ``tests/test_gradsync.py`` (d 64, vocab 256,
S 32, B 8): gradients, 4-step trajectories, one all-reduce per bucket
per step and one hook firing per leaf."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import gradsync as jgradsync
from repro.distributed.sharding import ParallelPlan as JParallelPlan
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.distributed import gradsync
from repro_torch.distributed.sharding import (GRAD_SYNC_BUCKETED, GRAD_SYNC_NONE,
                                              GRAD_SYNC_XLA, ParallelPlan)
from repro_torch.models.model import build_model
from repro_torch.models.params import flatten_tree
from repro_torch.models.transformer import model_specs
from repro_torch.train import train_step as tts
from repro_torch.train.optimizer import AdamWConfig

from _subproc import run_py

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, V = 8, 32, 256
SMALL_MB = 0.05
LEAF_REL, LEAF_FLOOR = 1e-6, 1e-8     # 2 ranks vs one process (the JAX test's bar)
JAX_REL = 1e-5                        # port vs JAX (tests/test_torch_train.py's bar)
OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# name -> (microbatch, ragged mask): the JAX test's two bucketed cases and
# the fused fallback (8 microbatches do not split a local batch of 4)
CASES = {"micro1_ragged": (1, True), "micro4_uniform": (4, False),
         "fallback_micro8": (8, True)}
WORKER_TIMEOUT = 120


def _jax_names(tree):
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append(".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path))
    return out


def _bucket_names(buckets, names):
    return [([names[i] for i in b.indices], b.nbytes) for b in buckets]


def _small_cfg():
    return dataclasses.replace(reduced(get_config("bert-mlm-120m"), d_model=64),
                               vocab_size=V, max_position=S)


# ---------------------------------------------------------------------------
# the bucket plan, leaf for leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["reduced_0.05mb", "full_25mb"])
def test_bucket_plan_equals_jax_by_leaf_name(which):
    from repro.configs import reduced as jreduced

    if which == "full_25mb":
        jcfg, tcfg, mb = jget_config("bert-mlm-120m"), get_config("bert-mlm-120m"), 25.0
    else:
        jcfg = dataclasses.replace(jreduced(jget_config("bert-mlm-120m"), d_model=64),
                                   vocab_size=V, max_position=S)
        tcfg, mb = _small_cfg(), SMALL_MB
    jtree = jbuild_model(jcfg).abstract(jnp.float32)
    jnames = _jax_names(jtree)
    jb = jgradsync.partition_buckets(jax.tree_util.tree_leaves(jtree), bucket_mb=mb)
    specs = flatten_tree(model_specs(tcfg))          # shapes only, no weights
    tnames = list(specs)
    leaves = [torch.empty(s.shape, device="meta") for s in specs.values()]
    tb = gradsync.partition_buckets(leaves, bucket_mb=mb)
    assert tnames == jnames
    assert _bucket_names(tb, tnames) == _bucket_names(jb, jnames)
    if which == "full_25mb":
        assert len(tb) == 11 and round(sum(b.nbytes for b in tb) / 1e6, 1) == 444.9
        assert [tnames[i] for i in tb[-2].indices] == ["embed.tokens"]
    else:
        assert len(tb) > 1


def test_bucket_plan_equals_jax_on_a_mixed_dtype_tree():
    shapes = [((64, 64), "bfloat16"), ((300,), "float32"), ((128, 96), "float32"),
              ((7,), "bfloat16"), ((64, 64), "bfloat16"), ((5000,), "float32")]
    jl = [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in shapes]
    tl = [torch.empty(s, device="meta", dtype=getattr(torch, d)) for s, d in shapes]
    for mb in (0.01, 0.03, 25.0):
        for rev in (True, False):
            jb = jgradsync.partition_buckets(jl, bucket_mb=mb, reverse=rev)
            tb = gradsync.partition_buckets(tl, bucket_mb=mb, reverse=rev)
            assert [(b.indices, b.nbytes) for b in tb] == [(b.indices, b.nbytes) for b in jb]
            assert [str(b.dtype).split(".")[-1] for b in tb] == [str(b.dtype) for b in jb]


def test_flat_leaves_follow_the_jax_order_not_registration_order():
    model = build_model(_small_cfg(), device="cpu")
    names = [n for n, _ in gradsync.flat_leaves(model)]
    assert names == list(flatten_tree(model.specs()))
    assert names != [n for n, _ in model.named_parameters()]


# ---------------------------------------------------------------------------
# the plan's strategy table
# ---------------------------------------------------------------------------

class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


PLAN_ROWS = [  # mesh axes (None: no mesh), global batch, microbatch, overlap
    (dict(data=4), 16, 1, True), (dict(data=4, model=2), 16, 1, True),
    (dict(data=4), 16, 4, True), (dict(data=4), 8, 4, True),
    (dict(data=1, model=1), 8, 1, True), (dict(data=2), 8, 1, True),
    (dict(data=2), 8, 4, True), (dict(data=2), 8, 8, True), (dict(data=2), 8, 3, True),
    (dict(data=2), 7, 1, True), (dict(data=2), 8, 1, False), (dict(data=2), 8, 8, False),
    (None, 8, 1, True),
]


@pytest.mark.parametrize("axes,gb,micro,overlap", PLAN_ROWS,
                         ids=[f"{a}-{g}-{m}-{o}" for a, g, m, o in PLAN_ROWS])
def test_plan_strategy_and_fallback_equal_jax(axes, gb, micro, overlap):
    mesh = FakeMesh(**axes) if axes else None
    world = int(np.prod(list(axes.values()))) if axes else None
    jp = JParallelPlan.make(mesh, "ddp", gb, microbatch=micro, overlap=overlap)
    tp = ParallelPlan.make(world, "ddp", gb, microbatch=micro, overlap=overlap)
    assert (tp.grad_sync, tp.fallback_reason, tp.dp_size, tp.local_batch) == \
        (jp.grad_sync, jp.fallback_reason, jp.dp_size, jp.local_batch), jp.describe()
    assert tp.describe()["grad_sync"] == jp.grad_sync


def test_plan_sizes_buckets_at_f32_under_accumulation_and_refuses_other_modes():
    model = build_model(_small_cfg(), device="cpu", dtype=torch.bfloat16)
    one = ParallelPlan.make(2, "ddp", 8, microbatch=1, grad_bucket_mb=1e6)
    four = ParallelPlan.make(2, "ddp", 8, microbatch=4, grad_bucket_mb=1e6)
    n = sum(p.numel() for p in model.parameters())
    assert one.grad_buckets(model)[0].nbytes == 2 * n
    assert four.grad_buckets(model)[0].nbytes == 4 * n
    assert ParallelPlan.make(2, "ddp", 8, overlap=False).grad_buckets(model) is None
    for mode, item in (("fsdp_tp", "A11"), ("tp", "A11"), ("pp_dp", "A11")):
        with pytest.raises(NotImplementedError, match=item):
            ParallelPlan.make(2, mode, 8)
    assert (GRAD_SYNC_BUCKETED, GRAD_SYNC_XLA, GRAD_SYNC_NONE) == \
        ("bucketed_overlap", "xla_fused", "none")


# ---------------------------------------------------------------------------
# two ranks on gloo, against one process and against JAX
# ---------------------------------------------------------------------------

JAX_BODY = """
    import dataclasses, json, sys, jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, reduced
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.distributed.sharding import ParallelPlan
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model
    from repro.train.train_step import init_state, make_grad_fn

    out, B, S, V = OUT_PATH, 8, 32, 256
    cases = json.loads(CASES_JSON)
    cfg = dataclasses.replace(reduced(get_config('bert-mlm-120m'), d_model=64),
                              vocab_size=V, max_position=S)
    model = build_model(cfg)
    mesh = make_host_mesh(2, 1)
    rng = np.random.RandomState(1)
    toks = rng.randint(4, V, (B, S)).astype(np.int32)
    ragged = (rng.rand(B, S) > 0.3).astype(np.float32)
    name = lambda p: '.'.join(str(getattr(k, 'key', getattr(k, 'idx', k))) for k in p)
    save = {'tokens': toks, 'labels': np.roll(toks, -1, 1), 'ragged': ragged}
    params = None
    for case, (micro, is_ragged) in cases.items():
        run = RunConfig(model=cfg, shape=ShapeConfig('t', S, B, 'train'), sharding='ddp',
                        param_dtype='float32', activation_dtype='float32', microbatch=micro)
        if params is None:
            params = init_state(model, jax.random.PRNGKey(0), run)['params']
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
                save['param/' + name(p)] = np.asarray(x)
        mask = ragged if is_ragged else np.ones((B, S), np.float32)
        batch = {'tokens': jnp.asarray(toks), 'labels': jnp.asarray(np.roll(toks, -1, 1)),
                 'loss_mask': jnp.asarray(mask)}
        plan = ParallelPlan.for_run(run, mesh, grad_bucket_mb=0.05)
        save[case + '/grad_sync'] = np.asarray(plan.grad_sync)
        loss, grads, met = jax.jit(make_grad_fn(model, run, mesh, plan))(params, batch)
        save[case + '/loss'] = np.asarray(loss)
        for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            save[case + '/grad/' + name(p)] = np.asarray(g)
    np.savez(out, **save)
"""

WORKER = """
    import dataclasses, json, sys, numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed import gradsync, maybe_initialize_distributed
    from repro_torch.distributed.sharding import ParallelPlan
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_state, make_grad_fn, make_train_step

    ref, out = sys.argv[1], sys.argv[2]
    cases, opt_kw = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    info = maybe_initialize_distributed('cpu')
    B, S, V = 8, 32, 256
    cfg = dataclasses.replace(reduced(get_config('bert-mlm-120m'), d_model=64),
                              vocab_size=V, max_position=S)
    z = np.load(ref)
    model = build_model(cfg, device='cpu')
    model.load_jax_params({k[6:]: z[k] for k in z.files if k.startswith('param/')})
    rows = slice(info.rank * 4, (info.rank + 1) * 4)
    save = {}
    for case, (micro, is_ragged) in cases.items():
        run = RunConfig(model=cfg, shape=ShapeConfig('t', S, B, 'train'), sharding='ddp',
                        param_dtype='float32', activation_dtype='float32', microbatch=micro)
        plan = ParallelPlan.for_run(run, info.world, grad_bucket_mb=0.05)
        mask = z['ragged'] if is_ragged else np.ones((B, S), np.float32)
        batch = {'tokens': torch.from_numpy(z['tokens'][rows]),
                 'labels': torch.from_numpy(z['labels'][rows]),
                 'loss_mask': torch.from_numpy(mask[rows])}
        save[case + '/grad_sync'] = np.asarray(plan.grad_sync)
        bk = plan.grad_buckets(model)
        save[case + '/n_buckets'] = np.asarray(len(bk) if bk else 1)
        params = init_state(model, run, seed=None)['params']
        gf = make_grad_fn(model, run, plan)
        gradsync.reset_counts()
        loss, grads, met = gf(params, batch)
        save[case + '/all_reduces'] = np.asarray(gradsync.counts['grad_all_reduce'])
        save[case + '/hooks'] = np.asarray(gf.sync.hook_fires if gf.sync else [1])
        save[case + '/loss'] = loss.numpy()
        for k, g in grads.items():
            save[case + '/grad/' + k] = g.numpy().copy()
        state = init_state(model, run, seed=None)
        step = make_train_step(model, run, AdamWConfig(**opt_kw), plan)
        per_step, hooks, losses, gnorms = [], [], [], []
        for _ in range(4):
            gradsync.reset_counts()
            state, m = step(state, batch)
            per_step.append(gradsync.counts['grad_all_reduce'])
            hooks.append(list(step.sync.hook_fires) if step.sync else [1])
            losses.append(m['loss'].item())
            gnorms.append(m['grad_norm'].item())
        save[case + '/step_all_reduces'] = np.asarray(per_step)
        save[case + '/step_hooks'] = np.asarray(hooks)
        save[case + '/losses'] = np.asarray(losses)
        save[case + '/grad_norms'] = np.asarray(gnorms)
        for k, p in state['params'].named_parameters():
            save[case + '/final/' + k] = p.detach().numpy().copy()
    np.savez(out, **save)
    torch.distributed.destroy_process_group()
"""


def spawn_ranks(tmp_path, body, args, world=2, timeout=WORKER_TIMEOUT):
    """Run ``body`` in ``world`` processes that join one gloo group through
    a file store under ``tmp_path`` (no port to share between parallel
    tests); kills them all and fails if one hangs past ``timeout``."""
    store = tmp_path / "store"
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "REPRO_COORDINATOR": f"file://{store}", "REPRO_NUM_PROCESSES": str(world),
               "REPRO_PROCESS_ID": str(rank), "REPRO_DIST_TIMEOUT_S": str(timeout)}
        procs.append(subprocess.Popen([sys.executable, "-c", textwrap.dedent(body),
                                       *[a.replace("{rank}", str(rank)) for a in args]],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank hung past {timeout} s")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    ref = str(tmp / "jax.npz")
    run_py(textwrap.dedent(JAX_BODY).replace("OUT_PATH", repr(ref))
           .replace("CASES_JSON", repr(json.dumps(CASES))), n_devices=2, timeout=300)
    spawn_ranks(tmp, WORKER, [ref, str(tmp / "rank{rank}.npz"), json.dumps(CASES),
                              json.dumps(OPT_KW)])
    z = np.load(ref)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return {"jax": dict(z), "ranks": ranks, "one": _one_process(z)}


def _one_process(z):
    """The port's one-process gradients and 4-step trajectory over the
    global batch, from the same JAX parameters."""
    cfg = _small_cfg()
    model = build_model(cfg, device="cpu")
    model.load_jax_params({k[6:]: z[k] for k in z.files if k.startswith("param/")})
    out = {}
    for case, (micro, is_ragged) in CASES.items():
        run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"), sharding="ddp",
                        param_dtype="float32", activation_dtype="float32", microbatch=micro)
        mask = z["ragged"] if is_ragged else np.ones((B, S), np.float32)
        batch = {"tokens": torch.from_numpy(z["tokens"]), "labels": torch.from_numpy(z["labels"]),
                 "loss_mask": torch.from_numpy(mask)}
        params = tts.init_state(model, run, seed=None)["params"]
        loss, grads, _ = tts.make_grad_fn(model, run)(params, batch)
        state = tts.init_state(model, run, seed=None)
        step = tts.make_train_step(model, run, AdamWConfig(**OPT_KW))
        losses, gnorms = [], []
        for _ in range(4):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
            gnorms.append(m["grad_norm"].item())
        out[case] = {"loss": loss.item(), "grads": {k: g.detach().numpy().copy()
                                                    for k, g in grads.items()},
                     "losses": losses, "grad_norms": gnorms}
    return out


def _close(got, want, rel, floor=LEAF_FLOOR):
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()) + floor)


BUCKETED = ["micro1_ragged", "micro4_uniform"]


@pytest.mark.parametrize("case", BUCKETED)
def test_two_ranks_sum_to_the_one_process_gradients(runs, case):
    one = runs["one"][case]
    for r in runs["ranks"]:
        assert str(r[case + "/grad_sync"]) == "bucketed_overlap"
        for k, want in one["grads"].items():
            _close(r[case + "/grad/" + k], want, LEAF_REL)
        np.testing.assert_allclose(float(r[case + "/loss"]), one["loss"], rtol=1e-6)


@pytest.mark.parametrize("case", BUCKETED)
def test_two_rank_trajectory_follows_one_process(runs, case):
    one = runs["one"][case]
    r0, r1 = runs["ranks"]
    np.testing.assert_allclose(r0[case + "/losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(r0[case + "/grad_norms"], one["grad_norms"], rtol=1e-5)
    # the replicas stay equal: same summed gradient, same update
    np.testing.assert_array_equal(r0[case + "/losses"], r1[case + "/losses"])
    for k in [k for k in r0 if k.startswith(case + "/final/")]:
        np.testing.assert_array_equal(r0[k], r1[k])


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_jax_on_a_two_device_mesh(runs, case):
    z = runs["jax"]
    assert str(z[case + "/grad_sync"]) == str(runs["ranks"][0][case + "/grad_sync"])
    for r in runs["ranks"]:
        for k in [k for k in z if k.startswith(case + "/grad/")]:
            _close(r[k], z[k], JAX_REL)
        np.testing.assert_allclose(float(r[case + "/loss"]), float(z[case + "/loss"]),
                                   rtol=JAX_REL)


def test_fallback_is_the_fused_all_reduce(runs):
    for r in runs["ranks"]:
        assert str(r["fallback_micro8/grad_sync"]) == "xla_fused"
        assert int(r["fallback_micro8/all_reduces"]) == 1
        assert list(r["fallback_micro8/step_all_reduces"]) == [1] * 4
    one = runs["one"]["fallback_micro8"]
    # global microbatches of one row each: the one-process step at
    # microbatch 8 splits the same way
    for k, want in one["grads"].items():
        _close(runs["ranks"][0]["fallback_micro8/grad/" + k], want, LEAF_REL)


@pytest.mark.parametrize("case", BUCKETED)
def test_one_all_reduce_per_bucket_per_step_and_every_hook_once(runs, case):
    for r in runs["ranks"]:
        nb = int(r[case + "/n_buckets"])
        assert nb > 1
        assert int(r[case + "/all_reduces"]) == nb
        assert list(r[case + "/step_all_reduces"]) == [nb] * 4
        assert (r[case + "/hooks"] == 1).all()
        assert (r[case + "/step_hooks"] == 1).all()

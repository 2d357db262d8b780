"""The port's fsdp (ZeRO-3, ``scatter_overlap``) training against the JAX
package on the CPU: the bucket plan and each rank's shard layout leaf for
leaf, the leaf <-> block layouts, the plan's strategy table, two ranks on
gloo against the JAX ``make_grad_fn`` and ``make_train_step`` on a
2-device mesh (gradients, 4-step trajectories, each device's shards),
against the port's own one-process and ddp paths, the collective counts
of all three branches, the sub-shard checkpoints both ways, and the CLI
under ``--sharding fsdp`` run and resumed from its step-2 checkpoint.  The model is the reduced
bert-mlm-120m of ``tests/test_gradsync.py``'s scatter test (d 64, vocab
511, S 32, B 8): the odd vocab leaves ``mlm.out_bias`` whole, so the psum
bucket runs beside the scatter buckets."""
import dataclasses
import json
import os
import re
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed import gradsync as jgradsync
from repro.distributed.sharding import ParallelPlan as JParallelPlan
from repro.models import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.distributed import gradsync
from repro_torch.distributed.sharding import (GRAD_SYNC_NONE, GRAD_SYNC_SCATTER,
                                              GRAD_SYNC_XLA, ParallelPlan)
from repro_torch.models.model import build_model
from repro_torch.models.params import ParamTree, flatten_tree, tree_map_specs
from repro_torch.models.transformer import model_specs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as tts
from repro_torch.train.optimizer import AdamWConfig

from _subproc import run_py
from test_torch_ddp import FakeMesh, _close, _jax_names, spawn_ranks
from test_torch_launch_train import _run_ranks, _step_lines

torch.set_num_threads(2)

B, S, V = 8, 32, 511
SMALL_MB = 0.05
JAX_REL = 1e-5                        # port vs JAX (the ddp test's bar)
LEAF_REL = 1e-6                       # port vs port, another sync
OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# name -> (microbatch, ragged mask): the JAX scatter test's two cases
CASES = {"micro1_ragged": (1, True), "micro4_uniform": (4, False)}


def _small_cfg():
    return dataclasses.replace(reduced(get_config("bert-mlm-120m"), d_model=64),
                               vocab_size=V, max_position=S)


def _jax_small_cfg():
    return dataclasses.replace(jreduced(jget_config("bert-mlm-120m"), d_model=64),
                               vocab_size=V, max_position=S)


def _meta_model(cfg):
    """The parameter tree of ``cfg`` as shapes only (meta tensors)."""
    return ParamTree(tree_map_specs(lambda s: torch.empty(s.shape, device="meta"),
                                    model_specs(cfg)))


def _run(cfg, micro, sharding="fsdp"):
    return RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"), sharding=sharding,
                     param_dtype="float32", activation_dtype="float32", microbatch=micro)


# ---------------------------------------------------------------------------
# the bucket plan and the shard layout, leaf for leaf
# ---------------------------------------------------------------------------

def _bucket_names(buckets, names):
    return [([names[i] for i in b.indices], b.nbytes) for b in buckets]


@pytest.mark.parametrize("which", ["reduced_0.05mb", "full_25mb"])
def test_fsdp_plan_and_layout_equal_jax_by_leaf_name(which):
    if which == "full_25mb":
        jcfg, tcfg, mb = jget_config("bert-mlm-120m"), get_config("bert-mlm-120m"), 25.0
    else:
        jcfg, tcfg, mb = _jax_small_cfg(), _small_cfg(), SMALL_MB
    jtree = jbuild_model(jcfg).abstract(jnp.float32)
    jnames = _jax_names(jtree)
    jleaves = jax.tree_util.tree_leaves(jtree)
    jsp = jgradsync.partition_fsdp_buckets(jleaves, 2, bucket_mb=mb)
    jspecs = jax.tree_util.tree_leaves(
        JParallelPlan.make(FakeMesh(data=2), "fsdp", 16).scatter_param_specs(jtree),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    model = _meta_model(tcfg)
    plan = ParallelPlan.make(2, "fsdp", 16, grad_bucket_mb=mb)
    sp = plan.scatter_plan(model)
    tnames = list(flatten_tree(model_specs(tcfg)))
    assert tnames == jnames
    assert sp.shard_dims == jsp.shard_dims
    assert _bucket_names(sp.scatter, tnames) == _bucket_names(jsp.scatter, jnames)
    assert _bucket_names(sp.psum, tnames) == _bucket_names(jsp.psum, jnames)
    assert (sp.scatter_bytes, sp.psum_bytes) == (jsp.scatter_bytes, jsp.psum_bytes)
    for r in range(2):
        layout = plan.shard_layout(model, r)
        assert list(layout) == tnames
        for (name, sh), spec, jl in zip(layout.items(), jspecs, jleaves):
            assert sh.global_shape == tuple(jl.shape)
            d = list(spec).index("data") if "data" in spec else None
            assert sh.dim == d == gradsync.shard_dim(jl, 2), name
            if d is not None:
                assert sh.shape == jgradsync.local_shape(jl.shape, d, 2)
                assert sh.offsets[d] == r * sh.shape[d]
    assert len(sp.scatter) > 1
    # the odd vocab leaves the out bias whole; at full size every leaf is cut
    assert [tnames[i] for b in sp.psum for i in b.indices] == \
        (["mlm.out_bias"] if which == "reduced_0.05mb" else [])


def test_fsdp_plan_equals_jax_on_a_mixed_dtype_tree_with_pins():
    shapes = [((64, 64), "bfloat16"), ((300,), "float32"), ((3, 96), "float32"),
              ((7,), "bfloat16"), ((1, 64, 6), "bfloat16"), ((5000,), "float32"),
              ((), "float32")]
    jl = [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in shapes]
    tl = [torch.empty(s, device="meta", dtype=getattr(torch, d)) for s, d in shapes]
    for n in (1, 2, 4):
        for mb in (0.005, 25.0):
            jsp = jgradsync.partition_fsdp_buckets(jl, n, bucket_mb=mb)
            tsp = gradsync.partition_fsdp_buckets(tl, n, bucket_mb=mb)
            assert tsp.shard_dims == jsp.shard_dims
            for tb, jb in ((tsp.scatter, jsp.scatter), (tsp.psum, jsp.psum)):
                assert [(b.indices, b.nbytes) for b in tb] == \
                    [(b.indices, b.nbytes) for b in jb]
                assert [str(b.dtype).split(".")[-1] for b in tb] == \
                    [str(b.dtype) for b in jb]


@pytest.mark.parametrize("shape,dim", [((6, 4), 0), ((3, 8), 1), ((1, 6, 4), 1),
                                       ((1, 3, 2, 8), 3), ((4,), 0)])
def test_leaf_blocks_round_trip_equals_jax(shape, dim):
    full = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jgradsync._leaf_to_blocks(jnp.asarray(full), dim, 2))
    got = gradsync._leaf_to_blocks(torch.from_numpy(full), dim, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    loc = gradsync.local_shape(shape, dim, 2)
    back = gradsync._blocks_to_leaf(got, loc, dim, 2)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jgradsync._blocks_to_leaf(jnp.asarray(want), loc, dim, 2)))
    np.testing.assert_array_equal(back.numpy(), full)


# ---------------------------------------------------------------------------
# the plan's strategy table
# ---------------------------------------------------------------------------

PLAN_ROWS = [  # mesh axes, global batch, microbatch, overlap (the JAX test's fsdp rows)
    (dict(data=4), 16, 1, True), (dict(data=4), 16, 4, True), (dict(data=4), 8, 4, True),
    (dict(data=1), 8, 1, True), (dict(data=2), 8, 3, True), (dict(data=2), 8, 1, False),
    (dict(data=2), 7, 1, True),
]


@pytest.mark.parametrize("axes,gb,micro,overlap", PLAN_ROWS,
                         ids=[f"{a}-{g}-{m}-{o}" for a, g, m, o in PLAN_ROWS])
def test_fsdp_plan_strategy_and_fallback_equal_jax(axes, gb, micro, overlap):
    world = int(np.prod(list(axes.values())))
    jp = JParallelPlan.make(FakeMesh(**axes), "fsdp", gb, microbatch=micro, overlap=overlap)
    tp = ParallelPlan.make(world, "fsdp", gb, microbatch=micro, overlap=overlap)
    assert (tp.grad_sync, tp.fallback_reason, tp.dp_size, tp.local_batch) == \
        (jp.grad_sync, jp.fallback_reason, jp.dp_size, jp.local_batch), jp.describe()
    # the port's one-microbatch branch is JAX's default donate_gather
    assert jp.donate_gather and tp.free_after_use == jp.free_after_use


def test_an_fsdp_plan_that_falls_back_does_not_run():
    plan = ParallelPlan.make(2, "fsdp", B, microbatch=3)
    assert (plan.grad_sync, plan.fallback_reason) == (GRAD_SYNC_XLA, "indivisible microbatch")
    model = build_model(_small_cfg(), device="cpu")
    with pytest.raises(ValueError, match="indivisible microbatch"):
        tts.make_train_step(model, _run(model.cfg, 3), AdamWConfig(), plan)
    assert ParallelPlan.make(None, "fsdp", B).grad_sync == GRAD_SYNC_NONE
    assert ParallelPlan.make(2, "fsdp", B).scatter_plan(model).n_shards == 2
    assert ParallelPlan.make(2, "ddp", B).scatter_plan(model) is None
    assert GRAD_SYNC_SCATTER == "scatter_overlap"


# ---------------------------------------------------------------------------
# two ranks on gloo, against JAX's two-device scatter step and the port
# ---------------------------------------------------------------------------

JAX_BODY = """
    import dataclasses, json, jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, reduced
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.distributed.sharding import ParallelPlan
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model
    from repro.train.optimizer import AdamWConfig
    from repro.train.train_step import init_state, make_grad_fn, make_train_step

    out, B, S, V = OUT_PATH, 8, 32, 511
    cases, opt_kw = json.loads(CASES_JSON), json.loads(OPT_JSON)
    cfg = dataclasses.replace(reduced(get_config('bert-mlm-120m'), d_model=64),
                              vocab_size=V, max_position=S)
    model = build_model(cfg)
    mesh = make_host_mesh(2, 1)
    devs = list(mesh.devices.flat)
    rng = np.random.RandomState(1)
    toks = rng.randint(4, V, (B, S)).astype(np.int32)
    ragged = (rng.rand(B, S) > 0.3).astype(np.float32)
    name = lambda p: '.'.join(str(getattr(k, 'key', getattr(k, 'idx', k))) for k in p)
    save = {'tokens': toks, 'labels': np.roll(toks, -1, 1), 'ragged': ragged}
    for case, (micro, is_ragged) in cases.items():
        run = RunConfig(model=cfg, shape=ShapeConfig('t', S, B, 'train'), sharding='fsdp',
                        param_dtype='float32', activation_dtype='float32', microbatch=micro)
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
        step = jax.jit(make_train_step(model, run, AdamWConfig(**opt_kw), mesh, plan=plan))
        state = init_state(model, jax.random.PRNGKey(0), run)
        losses, gnorms = [], []
        for _ in range(4):
            state, m = step(state, batch)
            losses.append(float(m['loss']))
            gnorms.append(float(m['grad_norm']))
        save[case + '/losses'] = np.asarray(losses)
        save[case + '/grad_norms'] = np.asarray(gnorms)
        for root, tree in (('params', state['params']), ('mu', state['opt']['mu']),
                           ('nu', state['opt']['nu'])):
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
                for sh in x.addressable_shards:
                    r = devs.index(sh.device)
                    k = f'{case}/final/{root}/{r}/{name(p)}'
                    save[k] = np.asarray(sh.data)
                    save[k + '@start'] = np.asarray([s.start or 0 for s in sh.index], np.int64)
        save[case + '/step'] = np.asarray(state['opt']['step'])
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
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_state, make_grad_fn, make_train_step,
                                              shard_state)

    ref, out, ck = sys.argv[1], sys.argv[2], sys.argv[3]
    cases, opt_kw = json.loads(sys.argv[4]), json.loads(sys.argv[5])
    info = maybe_initialize_distributed('cpu')
    B, S, V = 8, 32, 511
    cfg = dataclasses.replace(reduced(get_config('bert-mlm-120m'), d_model=64),
                              vocab_size=V, max_position=S)
    z = np.load(ref)
    model = build_model(cfg, device='cpu')
    model.load_jax_params({k[6:]: z[k] for k in z.files if k.startswith('param/')})
    rows = slice(info.rank * 4, (info.rank + 1) * 4)
    save = {}

    def counted(fn):
        gradsync.reset_counts()
        res = fn()
        return res, {k: gradsync.counts[k] for k in
                     ('param_all_gather', 'grad_reduce_scatter', 'grad_all_reduce')}

    def run_of(micro, sharding):
        return RunConfig(model=cfg, shape=ShapeConfig('t', S, B, 'train'), sharding=sharding,
                         param_dtype='float32', activation_dtype='float32', microbatch=micro)

    for case, (micro, is_ragged) in cases.items():
        run = run_of(micro, 'fsdp')
        mask = z['ragged'] if is_ragged else np.ones((B, S), np.float32)
        batch = {'tokens': torch.from_numpy(z['tokens'][rows]),
                 'labels': torch.from_numpy(z['labels'][rows]),
                 'loss_mask': torch.from_numpy(mask[rows])}
        for branch, kw in (('', {}), ('free/', {'free_after_use': True})):
            plan = ParallelPlan.for_run(run, info.world, grad_bucket_mb=0.05, **kw)
            sp = plan.scatter_plan(model)
            layout = plan.shard_layout(model, info.rank)
            save[case + '/' + branch + 'grad_sync'] = np.asarray(plan.grad_sync)
            save[case + '/n'] = np.asarray([len(sp.scatter), len(sp.psum)])
            params = shard_state(init_state(model, run, seed=None), layout)['params']
            (loss, grads, _), c = counted(lambda: make_grad_fn(model, run, plan)(params, batch))
            save[case + '/' + branch + 'loss'] = loss.numpy()
            save[case + '/' + branch + 'grad_counts'] = np.asarray(list(c.values()))
            for k, g in grads.items():
                save[case + '/' + branch + 'grad/' + k] = g.numpy().copy()
            state = shard_state(init_state(model, run, seed=None), layout)
            step = make_train_step(model, run, AdamWConfig(**opt_kw), plan)
            per_step, losses, gnorms = [], [], []
            for i in range(4):
                (state, m), c = counted(lambda: step(state, batch))
                per_step.append(list(c.values()))
                losses.append(m['loss'].item())
                gnorms.append(m['grad_norm'].item())
                if not branch and i == 1:
                    ckpt.save_sharded(f'{ck}/{case}-resume', state, step=2,
                                      process_index=info.rank, process_count=info.world)
            save[case + '/' + branch + 'step_counts'] = np.asarray(per_step)
            save[case + '/' + branch + 'losses'] = np.asarray(losses)
            save[case + '/' + branch + 'grad_norms'] = np.asarray(gnorms)
            if branch:
                continue
            for k, p in state['params'].named_parameters():
                save[case + '/final/params/' + k] = p.detach().numpy().copy()
            for m in ('mu', 'nu'):
                for k, v in state['opt'][m].items():
                    save[case + '/final/' + m + '/' + k] = v.numpy().copy()
            ckpt.save_sharded(f'{ck}/{case}', state, step=4, process_index=info.rank,
                              process_count=info.world)
            names = [k for k, _ in gradsync.flat_leaves(state['params'])]
            for root, leaves in (('params', [p.detach() for _, p in
                                             gradsync.flat_leaves(state['params'])]),
                                 ('mu', [state['opt']['mu'][k] for k in names]),
                                 ('nu', [state['opt']['nu'][k] for k in names])):
                for k, x in zip(names, gradsync.gather_grad_shards(leaves, sp)):
                    save[case + '/full/' + root + '/' + k] = x.numpy().copy()
            # resume: the step-2 checkpoint restored into a fresh state
            like = shard_state(init_state(model, run, seed=None), layout)
            state, _, _ = ckpt.restore_sharded(f'{ck}/{case}-resume', like,
                                               process_index=info.rank)
            save[case + '/resumed'] = np.asarray([step(state, batch)[1]['loss'].item()
                                                  for _ in range(2)])
        # the ddp path on the same rows
        dplan = ParallelPlan.for_run(run_of(micro, 'ddp'), info.world, grad_bucket_mb=0.05)
        params = init_state(model, run_of(micro, 'ddp'), seed=None)['params']
        _, grads, _ = make_grad_fn(model, run_of(micro, 'ddp'), dplan)(params, batch)
        for k, g in grads.items():
            save[case + '/ddp/' + k] = g.numpy().copy()
    np.savez(out, **save)
    torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    ref = str(tmp / "jax.npz")
    run_py(textwrap.dedent(JAX_BODY).replace("OUT_PATH", repr(ref))
           .replace("CASES_JSON", repr(json.dumps(CASES)))
           .replace("OPT_JSON", repr(json.dumps(OPT_KW))), n_devices=2, timeout=300)
    spawn_ranks(tmp, WORKER, [ref, str(tmp / "rank{rank}.npz"), str(tmp / "ck"),
                              json.dumps(CASES), json.dumps(OPT_KW)])
    z = dict(np.load(ref))
    return {"jax": z, "ranks": [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)],
            "one": _one_process(z), "ck": tmp / "ck", "tmp": tmp}


def _one_process(z):
    """The port's one-process gradients over the global batch, from the same
    JAX parameters."""
    cfg = _small_cfg()
    model = build_model(cfg, device="cpu")
    model.load_jax_params({k[6:]: z[k] for k in z if k.startswith("param/")})
    out = {}
    for case, (micro, is_ragged) in CASES.items():
        run = _run(cfg, micro, "ddp")
        mask = z["ragged"] if is_ragged else np.ones((B, S), np.float32)
        batch = {"tokens": torch.from_numpy(z["tokens"]), "labels": torch.from_numpy(z["labels"]),
                 "loss_mask": torch.from_numpy(mask)}
        params = tts.init_state(model, run, seed=None)["params"]
        loss, grads, _ = tts.make_grad_fn(model, run)(params, batch)
        out[case] = {"loss": loss.item(),
                     "grads": {k: g.detach().numpy().copy() for k, g in grads.items()}}
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_jax_scatter_grads_on_a_two_device_mesh(runs, case):
    z = runs["jax"]
    assert str(z[case + "/grad_sync"]) == "scatter_overlap"
    for r in runs["ranks"]:
        assert str(r[case + "/grad_sync"]) == "scatter_overlap"
        keys = [k for k in z if k.startswith(case + "/grad/")]
        assert keys and {k for k in r if k.startswith(case + "/grad/")} == set(keys)
        for k in keys:
            _close(r[k], z[k], JAX_REL)
        np.testing.assert_allclose(float(r[case + "/loss"]), float(z[case + "/loss"]),
                                   rtol=JAX_REL)


# a key bias's exact gradient is 0 (it shifts every score of a query row
# alike): AdamW moves it by about lr * sign(rounding noise) a step, in
# either package, so its shard is held to that bound
ZERO_GRAD = ("groups.0.0.mixer.bk",)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_trajectory_and_shards_equal_jax(runs, case):
    """4 steps of loss and grad norm within 1e-5 relative; each rank's
    shards of the parameters and moments within 1e-5 of the largest value
    of that state (AdamW's first steps move an element by about lr
    whatever its gradient's size, so f32 rounding of a near-zero gradient
    shows at the scale of the state, not of a small leaf)."""
    z = runs["jax"]
    for rank, r in enumerate(runs["ranks"]):
        np.testing.assert_allclose(r[case + "/losses"], z[case + "/losses"], rtol=JAX_REL)
        np.testing.assert_allclose(r[case + "/grad_norms"], z[case + "/grad_norms"],
                                   rtol=JAX_REL)
        for root in ("params", "mu", "nu"):
            pre = f"{case}/final/{root}/"
            want = {k[len(pre) + 2:]: z[k] for k in z
                    if k.startswith(f"{pre}{rank}/") and not k.endswith("@start")}
            got = {k[len(pre):]: r[k] for k in r if k.startswith(pre)}
            assert sorted(got) == sorted(want)
            scale = max(float(np.abs(w).max()) for w in want.values())
            for k, w in want.items():
                assert got[k].shape == w.shape, (root, k)
                if root == "params" and k in ZERO_GRAD:
                    assert max(np.abs(got[k]).max(), np.abs(w).max()) <= 4 * OPT_KW["lr"]
                    continue
                np.testing.assert_allclose(got[k], w, rtol=0, atol=JAX_REL * scale,
                                           err_msg=f"{root} {k}")
    np.testing.assert_array_equal(runs["ranks"][0][case + "/losses"],
                                  runs["ranks"][1][case + "/losses"])


@pytest.mark.parametrize("case", list(CASES))
def test_the_shard_layout_is_the_jax_devices(runs, case):
    """Each rank's parameter shard sits where JAX's device of that mesh
    position holds it."""
    z = runs["jax"]
    model = _meta_model(_small_cfg())
    for rank in range(2):
        layout = ParallelPlan.make(2, "fsdp", B).shard_layout(model, rank)
        for name, sh in layout.items():
            k = f"{case}/final/params/{rank}/{name}"
            assert tuple(z[k + "@start"]) == sh.offsets and z[k].shape == sh.shape, name


@pytest.mark.parametrize("case", list(CASES))
def test_the_gradients_equal_the_port_one_process_and_ddp(runs, case):
    one = runs["one"][case]
    for r in runs["ranks"]:
        for k, want in one["grads"].items():
            _close(r[f"{case}/ddp/{k}"], r[f"{case}/grad/{k}"], LEAF_REL)
            _close(r[f"{case}/grad/{k}"], want, LEAF_REL)
        np.testing.assert_allclose(float(r[case + "/loss"]), one["loss"], rtol=LEAF_REL)


@pytest.mark.parametrize("case", list(CASES))
def test_free_after_use_gives_the_donate_gather_gradients(runs, case):
    for r in runs["ranks"]:
        assert str(r[case + "/free/grad_sync"]) == "scatter_overlap"
        for k in [k for k in r if k.startswith(case + "/grad/")]:
            _close(r[k.replace("/grad/", "/free/grad/")], r[k], LEAF_REL)
        np.testing.assert_allclose(r[case + "/free/losses"], r[case + "/losses"], rtol=LEAF_REL)


@pytest.mark.parametrize("case", list(CASES))
def test_collective_counts_of_all_three_branches(runs, case):
    micro = CASES[case][0]
    for r in runs["ranks"]:
        ns, npsum = (int(x) for x in r[case + "/n"])
        assert ns > 1 and npsum == 1
        # donate_gather at one microbatch, gather once at four: one gather
        # and one reduce-scatter a scatter bucket, one all-reduce a psum one
        assert r[case + "/step_counts"].tolist() == [[ns, ns, npsum]] * 4
        # free_after_use: gathered again in each microbatch's backward
        assert r[case + "/free/step_counts"].tolist() == \
            [[2 * micro * ns, micro * ns, npsum]] * 4
        assert r[case + "/grad_counts"].tolist() == [ns, ns, npsum]


# ---------------------------------------------------------------------------
# sub-shard checkpoints, both ways, and the resume
# ---------------------------------------------------------------------------

def _jax_like():
    tree = jbuild_model(_jax_small_cfg()).abstract(jnp.float32)
    return {"params": tree, "opt": {"mu": tree, "nu": tree,
                                    "step": jax.ShapeDtypeStruct((), jnp.int32)}}


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_restores_a_two_rank_port_checkpoint(runs):
    case = "micro1_ragged"
    d = ckpt.step_dir(str(runs["ck"] / case), 4)
    subs = []
    for r in range(2):
        with open(os.path.join(d, f"shard-{r:05d}.subshards.json")) as f:
            subs.append(json.load(f))
    assert subs[0].keys() == subs[1].keys() and "params/mlm/out_bias" not in subs[0]
    regions = [_flat_jax(jckpt.restore(os.path.join(d, f"shard-{r:05d}.npz"), _jax_like()))
               for r in range(2)]
    full = runs["ranks"][0]
    for key in regions[0]:
        if key == "opt/step":
            assert int(regions[0][key]) == int(regions[1][key]) == 4
            continue
        root, name = key.split("/", 1) if key.startswith("params") else key[4:].split("/", 1)
        want = full[f"{case}/full/{root}/{name.replace('/', '.')}"]
        if key in subs[0]:     # the two ranks' parts tile the leaf exactly once
            parts = [p for s in subs for p in s[key]["parts"]]
            assert sum(int(np.prod(p["shape"])) for p in parts) == want.size
            np.testing.assert_array_equal(regions[0][key] + regions[1][key], want)
        else:
            np.testing.assert_array_equal(regions[0][key], want)
            np.testing.assert_array_equal(regions[1][key], want)


def test_a_jax_sub_shard_checkpoint_restores_into_the_port_shards(runs, tmp_path):
    """JAX's ``SubShardLeaf.from_parts`` + ``save_sharded`` writes the
    two processes' parts of JAX's own final state (whole leaves as one
    full part, as a replicated leaf of a cross-process mesh is stored);
    the port restores each rank's shards from it bit for bit."""
    case, z = "micro1_ragged", runs["jax"]
    jtree = jbuild_model(_jax_small_cfg()).abstract(jnp.float32)
    names = _jax_names(jtree)
    treedef = jax.tree_util.tree_structure(jtree)
    for r in range(2):
        def part(root, name):
            k = f"{case}/final/{root}/{r}/{name}"
            gshape = z[f"param/{name}"].shape
            return jckpt.SubShardLeaf.from_parts(gshape, [(z[k + "@start"], z[k])])

        state = {root: jax.tree_util.tree_unflatten(treedef, [part(root, n) for n in names])
                 for root in ("params", "mu", "nu")}
        state = {"params": state["params"], "opt": {"mu": state["mu"], "nu": state["nu"],
                                                    "step": z[case + "/step"]}}
        jckpt.save_sharded(str(tmp_path), state, step=4, process_index=r, process_count=2)
    cfg = _small_cfg()
    model = build_model(cfg, device="cpu")
    plan = ParallelPlan.make(2, "fsdp", B, grad_bucket_mb=SMALL_MB)
    for r in range(2):
        like = tts.shard_state(tts.init_state(model, _run(cfg, 1), seed=None),
                               plan.shard_layout(model, r))
        got, _, manifest = ckpt.restore_sharded(str(tmp_path), like, process_index=r)
        assert manifest["process_count"] == 2 and int(got["opt"]["step"]) == 4
        for k, p in got["params"].named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), z[f"{case}/final/params/{r}/{k}"])
        for m in ("mu", "nu"):
            for k, v in got["opt"][m].items():
                np.testing.assert_array_equal(v.numpy(), z[f"{case}/final/{m}/{r}/{k}"])
    # onto another plan: one process, or the ranks' layout on 4 ranks
    whole = tts.init_state(model, _run(cfg, 1), seed=None)
    with pytest.raises(NotImplementedError, match="A12"):
        ckpt.restore_sharded(str(tmp_path), whole, process_index=0)
    four = tts.shard_state(whole, ParallelPlan.make(4, "fsdp", B).shard_layout(model, 1))
    with pytest.raises(NotImplementedError, match="A12"):
        ckpt.restore_sharded(str(tmp_path), four, process_index=1)


@pytest.mark.parametrize("case", list(CASES))
def test_a_resume_under_fsdp_repeats_the_losses(runs, case):
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r[case + "/resumed"], r[case + "/losses"][2:])


def test_each_rank_holds_half_of_the_cut_leaves(tmp_path):
    model = build_model(_small_cfg(), device="cpu")
    plan = ParallelPlan.make(2, "fsdp", B, grad_bucket_mb=SMALL_MB)
    sp = plan.scatter_plan(model)
    for r in range(2):
        st = tts.shard_state(tts.init_state(model, _run(model.cfg, 1), seed=None),
                             plan.shard_layout(model, r))
        want = sp.scatter_bytes // 2 + sp.psum_bytes
        assert sum(p.nbytes for p in st["params"].parameters()) == want
        for m in ("mu", "nu"):
            assert sum(v.nbytes for v in st["opt"][m].values()) == want
        with pytest.raises(NotImplementedError, match="fsdp"):
            ckpt.save(str(tmp_path / "flat"), st)


# ---------------------------------------------------------------------------
# the CLI on two ranks, run and resumed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch_fsdp")
    ck = str(tmp / "ck")
    base = ["--device", "cpu", "--reduced", "--steps", "4", "--seq", "32", "--batch", "4",
            "--n-functions", "150", "--workers", "2", "--log-every", "1",
            "--data-dir", str(tmp / "data"), "--sharding", "fsdp", "--grad-bucket-mb", "1",
            "--ckpt-dir", ck, "--ckpt-every", "2"]
    first = _run_ranks(base, tmp, "first")
    layout = sorted(os.listdir(ckpt.step_dir(ck, 2)))
    resumed = _run_ranks(base + ["--resume", "--ckpt-step", "2"], tmp, "resumed")
    return {"first": first, "resumed": resumed, "layout": layout}


def test_the_cli_runs_fsdp_on_two_ranks(cli):
    for rank, (rc, out, err) in enumerate(cli["first"]):
        assert rc == 0 and "[done]" in out, err[-3000:]
        m = re.search(r"^\[plan\] mode=fsdp dp_axes=\['data'\] dp_size=2 "
                      r"grad_sync=scatter_overlap buckets=(\d+) comm=[\d.]+MB/step "
                      r"wire=[\d.]+MB/dev gather=([\d.]+)MB$", out, re.M)
        assert m and float(m.group(2)) > 0, out
        g = re.search(rf"^\[gradsync\] rank={rank} all_gathers=(\d+) reduce_scatters=(\d+) "
                      r"all_reduces=(\d+) per_step=(\d+)/(\d+)/(\d+) "
                      r"scatter_buckets=(\d+) psum_buckets=(\d+)$", out, re.M)
        assert g, out
        ns, npsum = int(g.group(7)), int(g.group(8))
        assert ns >= 1 and [int(x) for x in g.groups()[3:6]] == [ns, ns, npsum]
    assert cli["layout"] == ["manifest.json", "shard-00000.npz", "shard-00000.pipeline.json",
                             "shard-00000.subshards.json", "shard-00001.npz",
                             "shard-00001.pipeline.json", "shard-00001.subshards.json"]
    assert _step_lines(cli["first"][0][1]) == _step_lines(cli["first"][1][1])


def test_the_cli_resumes_fsdp_bit_for_bit(cli):
    for rank, (rc, out, err) in enumerate(cli["resumed"]):
        assert rc == 0, err[-3000:]
        assert f"[resume] host {rank} restored shard at step 2" in out
        want, got = _step_lines(cli["first"][rank][1]), _step_lines(out)
        assert sorted(got) == [3, 4] and {s: want[s] for s in got} == got

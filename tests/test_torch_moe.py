"""The port's mixture-of-experts slice (mixtral-8x7b, phi3.5-moe) against
the JAX package on the CPU, in f32: the configs field for field at full
size and reduced, their parameter counts (total and active); the ``moe``
leaves loaded from JAX; the router (weights, expert indices, aux) and the
sparse dispatch against JAX's dense one (outputs and gradients, with and
without a shared expert); the logits in train and prefill mode and the
paged engine's tokens and logits (JAX with its Pallas flash kernel in
interpret mode, and with its jnp attention); the loss, ``aux_loss`` and
every gradient leaf at microbatch 1 and 2; 20 steps on the launcher's
rolled labels; two gloo ranks under ddp and fsdp against JAX's
two-device step, the router's statistics averaged over the ranks; the
``xla_fused`` fallback over two ranks against JAX's (ROADMAP C16, its
router statistics summed over the pieces of each global microbatch);
the launchers.

The test models are the reduced configs (``configs.base.reduced``) at 2
MoE layers, built in both packages by ``dataclasses.replace``, with the
full models' experts (mixtral 8, phi3.5 16, top 2) and GQA ratio (8 q
heads over 2 kv heads of 64, as their 32 / 8).  Inputs come from numpy
seeds and go to both packages.

Top-k is discontinuous: every comparison first asserts that both
packages chose the same experts for every token of every router call
(``RouteTaps``); where they do not, it reports the port's smallest gap
between a token's k-th and (k+1)-th probability, so that a flip reads
as one and not as a tolerance miss."""
import dataclasses
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ATTN as JATTN
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import uniform_schedule as juniform
from repro.core import scaling as jscaling
from repro.core.accum import accumulate_grads as jaccumulate
from repro.distributed.sharding import ParallelPlan as JParallelPlan
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch.configs import default_run_config, get_config, list_archs, reduced
from repro_torch.configs.base import ATTN, LayerSpec, RunConfig, ShapeConfig, uniform_schedule
from repro_torch.core import scaling
from repro_torch.core.accum import accumulate_grads
from repro_torch.data import DataPipeline
from repro_torch.distributed.sharding import (GRAD_SYNC_BUCKETED, GRAD_SYNC_SCATTER,
                                              ParallelPlan)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as cli
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import flatten_tree, init_params, tree_map_paths
from repro_torch.serve.engine import PagedServeEngine
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts

from _subproc import run_py
from test_torch_ddp import FakeMesh, spawn_ranks
from test_torch_gemma2 import ENGINE_KW, MAX_NEW, _drive
from test_torch_gemma_train import _batch, _jbatch, _leaf_err, _runs, _tbatch, one_thread  # noqa: F401
from test_torch_train import TRAJ_REL

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-5)          # f32 on both sides, summed in other orders
LOSS_REL = 1e-5
LEAF_REL = 1e-5                           # |g - g_jax| <= 1e-5 max|g_jax| + 1e-8, per leaf
MOE = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
EXPERTS = {"mixtral-8x7b": 8, "phi3.5-moe-42b-a6.6b": 16}
HEADS = dict(n_heads=8, n_kv_heads=2, head_dim=64)
PARAMS = {"mixtral-8x7b": (46_702_792_704, 12_879_925_248),
          "phi3.5-moe-42b-a6.6b": (41_872_793_600, 6_640_640_000)}


def moe_cfgs(arch, d_model=256, n_layers=2):
    """(JAX, port) configs of the reduced ``arch`` at ``n_layers`` MoE
    layers, the full model's expert count, top-k and GQA ratio."""
    def cut(cfg, red, spec, sched):
        cfg = red(cfg, d_model=d_model)
        moe = dataclasses.replace(cfg.moe, n_experts=EXPERTS[arch], top_k=2)
        kw = HEADS if d_model == 256 else {}
        return dataclasses.replace(cfg, schedule=sched(n_layers, spec), moe=moe, **kw)

    return (cut(jget_config(arch), jreduced, JLayerSpec(kind=JATTN, moe=True), juniform),
            cut(get_config(arch), reduced, LayerSpec(kind=ATTN, moe=True), uniform_schedule))


def _redraw(params, seed):
    """Norm scales (ones at init) re-drawn around 1 and biases (zeros)
    around 0, so that every leaf carries information."""
    rng = np.random.RandomState(seed)
    for path, a in flatten_tree(params).items():
        leaf = path.rsplit(".", 1)[-1]
        if leaf == "scale":
            a[...] = 1.0 + 0.2 * rng.standard_normal(a.shape)
        elif leaf == "bias":
            a[...] = 0.1 * rng.standard_normal(a.shape)
    return params


_MODELS = {}


def models(arch):
    """One JAX-initialised parameter set in both packages, built once per
    arch."""
    if arch not in _MODELS:
        jcfg, tcfg = moe_cfgs(arch)
        jmodel = jbuild_model(jcfg)
        params = _redraw(jax.tree_util.tree_map(np.array, jmodel.init(jax.random.PRNGKey(3))), 3)
        tmodel = build_model(tcfg, device="cpu")
        tmodel.load_jax_params(params)
        _MODELS[arch] = (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel)
    return _MODELS[arch]


class RouteTaps:
    """Every router call's expert indices in both packages, in call
    order: the port's with its smallest top-k gap, JAX's through a
    debug callback (the layers run under ``lax.scan`` and ``jit``)."""

    def __init__(self, monkeypatch):
        self.port, self.jax = [], []
        t_route, j_route = tmoe.route, jmoe.route

        def port(p, x, cfg, stat_reduce=None):
            w, idx, aux = t_route(p, x, cfg, stat_reduce=stat_reduce)
            with torch.no_grad():
                top = torch.softmax(x.float() @ p["router"].float(), -1).topk(
                    cfg.moe.top_k + 1).values
            self.port.append((idx.numpy().copy(), float((top[:, -2] - top[:, -1]).min())))
            return w, idx, aux

        def jx(p, x, cfg, stat_axes=None):
            w, idx, aux = j_route(p, x, cfg, stat_axes=stat_axes)
            jax.debug.callback(lambda i: self.jax.append(np.asarray(i).copy()), idx,
                               ordered=True)
            return w, idx, aux

        monkeypatch.setattr(tmoe, "route", port)
        monkeypatch.setattr(jmoe, "route", jx)

    def clear(self):
        self.port.clear()
        self.jax.clear()

    def assert_same(self):
        jax.effects_barrier()
        assert len(self.port) == len(self.jax) > 0, (len(self.port), len(self.jax))
        for i, ((got, gap), want) in enumerate(zip(self.port, self.jax)):
            if not np.array_equal(got, want):
                pytest.fail(f"router call {i}: expert indices differ on "
                            f"{int((got != want).any(-1).sum())} of {len(got)} tokens; "
                            f"the port's smallest top-k gap there {gap:.3e}")
        self.clear()


@pytest.fixture
def taps(monkeypatch):
    return RouteTaps(monkeypatch)


def _tokens(jcfg, S, seed):
    return np.random.RandomState(seed).randint(4, jcfg.vocab_size, (1, S)).astype(np.int32)


def _cache_leaves(tree):
    return {f"{pi}.{name}": leaf for pi, layer in enumerate(tree["groups"][0])
            for name, leaf in layer["mixer"].items()}


# ---------------------------------------------------------------------------
# the configs and the parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", MOE)
def test_config_matches_jax_field_for_field(arch, size):
    """Both MoE archs are in the port's registry and equal the JAX
    package's configs in every field, at full size and reduced."""
    assert arch in list_archs()
    tcfg, jcfg = get_config(arch), jget_config(arch)
    if size == "reduced":
        tcfg, jcfg = reduced(tcfg), jreduced(jcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert all(s.moe for g in tcfg.schedule for s in g.pattern)
    if size == "full":
        assert (tcfg.moe.n_experts, tcfg.moe.top_k, tcfg.moe.n_shared) == (EXPERTS[arch], 2, 0)
        assert tcfg.n_heads // tcfg.n_kv_heads == 4 and tcfg.head_dim == 128


@pytest.mark.parametrize("arch", MOE)
def test_param_count_total_and_active_match_jax(arch):
    """The exact count from the spec tree, equal to JAX's; the active
    count takes top_k / n_experts of the expert leaves; the model FLOPs
    6 N_active D."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    n, act = scaling.param_count(cfg), scaling.param_count(cfg, active_only=True)
    assert (n, act) == (jscaling.param_count(jcfg),
                        jscaling.param_count(jcfg, active_only=True)) == PARAMS[arch]
    assert scaling.model_flops(cfg, 10) == 60.0 * act


@pytest.mark.parametrize("arch", MOE)
def test_from_jax_params_round_trips_the_moe_leaves(arch):
    """Every leaf, the stacked router (L, d, E) and experts (L, E, d, f)
    among them, loads bit for bit from the JAX tree."""
    jcfg, _, params, tmodel = models(arch)
    flat = flatten_tree(jax.tree_util.tree_map(np.array, params))
    sd = tmodel.state_dict()
    assert sorted(sd) == sorted(flat)
    E, d, f = EXPERTS[arch], jcfg.d_model, jcfg.moe.expert_ff
    assert sd["groups.0.0.moe.router"].shape == (2, d, E)
    assert sd["groups.0.0.moe.wi"].shape == (2, E, d, f)
    assert sd["groups.0.0.moe.wo"].shape == (2, E, f, d)
    assert not any(".mlp." in k for k in sd)
    for k, a in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)


def test_bf16_draw_takes_a_row_at_a_time():
    """A stacked leaf drawn in bf16 is a function of the seed alone, one
    f32 row at a time: on the CPU the rows of one draw are the whole f32
    draw's, each rounded once (a row of a multiple of 16 elements)."""
    _, tcfg = moe_cfgs("mixtral-8x7b")
    specs = tmoe.moe_specs(tcfg)
    from repro_torch.models.params import stack_specs

    stacked = stack_specs({"wi": specs["wi"]}, 3)
    a = init_params(stacked, torch.Generator().manual_seed(5), torch.bfloat16, "cpu")["wi"]
    b = init_params(stacked, torch.Generator().manual_seed(5), torch.float32, "cpu")["wi"]
    assert a.dtype == torch.bfloat16 and a.shape == b.shape
    assert torch.equal(a, b.to(torch.bfloat16))
    assert torch.equal(a, init_params(stacked, torch.Generator().manual_seed(5),
                                      torch.bfloat16, "cpu")["wi"])
    # JAX's fan-in rule: E d for wi (L, E, d, f)
    np.testing.assert_allclose(b.std().item(), (8 * 256) ** -0.5, rtol=0.02)


# ---------------------------------------------------------------------------
# the router and the dispatch against JAX's dense oracle
# ---------------------------------------------------------------------------


def _moe_leaves(arch, n_shared, seed):
    """One MoE layer's leaves drawn by JAX (the router re-drawn at scale
    0.5: well separated top-k gaps) and its config."""
    jcfg, tcfg = moe_cfgs(arch, d_model=64)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, n_shared=n_shared))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, n_shared=n_shared))
    from repro.models.params import init_params as jinit

    p = jax.tree_util.tree_map(np.array, jinit(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed)))
    p["router"] = 0.5 * np.random.RandomState(seed).standard_normal(p["router"].shape
                                                                     ).astype(np.float32)
    assert sorted(p) == sorted(tmoe.moe_specs(tcfg))
    return jcfg, tcfg, p


@pytest.mark.parametrize("arch", MOE)
def test_route_matches_jax(arch):
    """w, the expert indices (exactly) and the Switch aux of 300 tokens."""
    jcfg, tcfg, p = _moe_leaves(arch, 0, 1)
    x = np.random.RandomState(2).standard_normal((300, jcfg.d_model)).astype(np.float32)
    jw, jidx, jaux = jmoe.route({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    tw, tidx, taux = tmoe.route({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=LOSS_REL)
    assert taux.item() > 0 and tidx.shape == (300, 2)


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("arch", MOE)
def test_sparse_dispatch_matches_jax_dense(arch, n_shared):
    """``apply_moe`` (each expert on its own tokens) against JAX's
    ``apply_moe_dense`` (every expert on every token): the output, the
    aux, and the gradients of x and of every leaf under one cotangent."""
    jcfg, tcfg, p = _moe_leaves(arch, n_shared, 4)
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jfn(pp, xx):
        out, aux = jmoe.apply_moe_dense(pp, xx, jcfg)
        return jnp.sum(out * ct) + 3.0 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.apply_moe(tp, tx, tcfg)
    ((out * torch.from_numpy(ct)).sum() + 3.0 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=LOSS_REL)
    worst = {"x": _leaf_err(tx.grad.numpy(), np.asarray(jgx))}
    worst.update({k: _leaf_err(tp[k].grad.numpy(), np.asarray(jgp[k])) for k in p})
    assert len(worst) == 5 + 3 * n_shared
    assert max(worst.values()) <= 1.0, worst


def test_dispatch_refuses_expert_parallel():
    _, tcfg, p = _moe_leaves("mixtral-8x7b", 0, 1)
    x = torch.zeros(1, 4, tcfg.d_model)
    for impl in ("ep", "ep_shard"):
        with pytest.raises(NotImplementedError, match="A11"):
            tmoe.apply_moe({k: torch.from_numpy(v) for k, v in p.items()}, x, tcfg, impl=impl)


# ---------------------------------------------------------------------------
# the forward: train logits, prefill, the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_train_logits_and_aux_match_jax(arch, taps):
    """The whole model in train mode: the same experts for every token of
    both layers, the logits and the summed aux."""
    jcfg, jmodel, params, tmodel = models(arch)
    toks = _tokens(jcfg, 45, 3)
    want, _, jaux = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.no_grad():
        got, _, aux = tmodel.apply({"tokens": torch.from_numpy(toks).long()}, mode="train")
    taps.assert_same()
    assert got.shape == (1, 45, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=LOSS_REL)
    assert aux.item() > 0


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("S,L,use_pallas", [(40, 40, False), (128, 101, True)])
def test_prefill_matches_jax(arch, S, L, use_pallas, taps):
    """A prompt of L tokens right-padded to S (the padding routes too):
    the experts, the hidden state, both layers' K/V caches and, for an
    unpadded prompt, the last position's logits; at S 128 the JAX side
    runs its Pallas flash kernel in interpret mode."""
    jcfg, jmodel, params, tmodel = models(arch)
    toks = np.zeros((1, S), np.int32)
    toks[0, :L] = _tokens(jcfg, L, S + L)[0]
    kw = dict(mode="prefill", paged={"length": L})
    jh, jcache, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, return_hidden=True,
                                 use_pallas=use_pallas,
                                 **{**kw, "paged": {"length": jnp.int32(L)}})
    with torch.inference_mode():
        th, tcache, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()},
                                     return_hidden=True, **kw)
    taps.assert_same()
    np.testing.assert_allclose(th[:, :L].numpy(), np.asarray(jh)[:, :L], **TOL)
    for name, leaf in _cache_leaves(jcache).items():
        got = _cache_leaves(tcache)[name].numpy()
        assert got.shape == leaf.shape, name
        np.testing.assert_allclose(got, np.asarray(leaf), err_msg=name, **TOL)
    if L == S:
        jl, _, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                use_pallas=use_pallas)
        with torch.inference_mode():
            tl, _, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()}, mode="prefill")
        taps.assert_same()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl).reshape(tl.shape), **TOL)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_matches_jax_tokens_and_logits(arch, use_pallas, taps):
    """The paged engines of both packages on the same staggered requests
    (3 slots, the last request waiting): the same experts in every
    prefill and decode tick (inactive slots route too, as in JAX), the
    same greedy tokens, and every prefill's and tick's logits within TOL;
    JAX with its Pallas flash and paged kernels in interpret mode, or its
    jnp oracles."""
    jcfg, jmodel, params, tmodel = models(arch)
    run = JRunConfig(model=jcfg, shape=JShapeConfig("s", 16, 2, "decode"), sharding="ddp",
                     param_dtype="float32", activation_dtype="float32", use_pallas=use_pallas)
    jeng = JPagedServeEngine(model=jmodel, run=run, use_pallas_decode=use_pallas, **ENGINE_KW)
    want_tokens, want_log = _drive(jeng, lambda: jeng.step(params), jcfg)
    eng = PagedServeEngine(tmodel, default_run_config(tmodel.cfg,
                                                      ShapeConfig("s", 16, 2, "decode")),
                           **ENGINE_KW)
    got_tokens, got_log = _drive(eng, eng.step, jcfg)
    taps.assert_same()
    assert got_tokens == want_tokens
    assert [k for k, _ in got_log] == [k for k, _ in want_log]
    assert sum(k == "decode" for k, _ in got_log) > MAX_NEW
    for i, ((kind, got), (_, want)) in enumerate(zip(got_log, want_log)):
        np.testing.assert_allclose(got, want, err_msg=f"{kind} {i}", **TOL)


# ---------------------------------------------------------------------------
# training: the loss, aux_loss, every gradient leaf, 20 steps
# ---------------------------------------------------------------------------


def _grad_errors(tgrads, jgrads):
    jflat = flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(tgrads)
    return {k: _leaf_err(tgrads[k].numpy(), w) for k, w in jflat.items()}


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_loss_aux_and_every_grad_leaf_match_jax(arch, microbatch, use_pallas, taps):
    """The next-token loss on the launcher's rolled labels (the last row
    partly padding), its metrics with ``aux_loss`` and every gradient
    leaf (router and experts through the top-k weights and the aux,
    through rematerialised layers) against ``jax.value_and_grad`` of the
    JAX ``loss_for``, accumulated over the microbatches; the experts of
    each microbatch's forward first.  JAX with its Pallas flash and xent
    in interpret mode (``use_pallas``) or its jnp attention."""
    jcfg, jmodel, params, tmodel = models(arch)
    jrun, trun = _runs(jcfg, tmodel.cfg, use_pallas, microbatch=microbatch)
    b = _batch(4, jcfg.vocab_size)
    rows = b["tokens"].shape[0] // microbatch
    for m in range(microbatch):
        mb = b["tokens"][m * rows:(m + 1) * rows]
        jmodel.apply(params, {"tokens": jnp.asarray(mb)}, mode="train", use_pallas=use_pallas)
        with torch.no_grad():
            tmodel.apply({"tokens": torch.from_numpy(mb).long()}, mode="train")
    taps.assert_same()
    jloss, jgrads, jmet = jaccumulate(
        lambda p, bb: jts.loss_for(jmodel, p, bb, run=jrun), params, _jbatch(b), microbatch)
    state = tts.init_state(tmodel, trun, seed=None)
    tloss, tgrads, tmet = accumulate_grads(
        lambda p, bb: tts.loss_for(tmodel, p, bb, run=trun), state["params"], _tbatch(b),
        microbatch)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_REL)
    for k in ("xent", "acc", "tokens", "aux_loss", "loss"):
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=LOSS_REL, atol=1e-7,
                                   err_msg=k)
    assert tmet["aux_loss"].item() > 0
    assert tgrads["groups.0.0.moe.router"].abs().max() > 0
    worst = _grad_errors(tgrads, jgrads)
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("arch", MOE)
def test_20_step_trajectory_matches_jax(arch):
    """Both packages' train steps (remat, chunked next-token loss plus the
    aux, AdamW) on the same 20 batches, JAX with its jnp attention; the
    loss falls and follows JAX at TRAJ_REL."""
    jcfg, jmodel, params, tmodel = models(arch)
    jrun, trun = _runs(jcfg, tmodel.cfg)
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=20, weight_decay=0.1)
    jstep = jax.jit(jts.make_train_step(jmodel, jrun, joptim.AdamWConfig(**opt)))
    jstate = {"params": params, "opt": joptim.init_opt_state(params)}
    # the port's step updates the parameters in place: it trains a copy
    tmodel2 = build_model(tmodel.cfg, device="cpu")
    tmodel2.load_state_dict(tmodel.state_dict())
    tstep = tts.make_train_step(tmodel2, trun, toptim.AdamWConfig(**opt))
    tstate = tts.init_state(tmodel2, trun, seed=None)
    jl, tl, ta = [], [], []
    for i in range(20):
        b = _batch(100 + i, jcfg.vocab_size)
        jstate, jm = jstep(jstate, _jbatch(b))
        tstate, tm = tstep(tstate, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        ta.append((tm["aux_loss"].item(), float(jm["aux_loss"])))
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)
    np.testing.assert_allclose(*zip(*ta), rtol=TRAJ_REL)


# ---------------------------------------------------------------------------
# data parallel: the plan, two gloo ranks against JAX's two-device step
# ---------------------------------------------------------------------------


PLAN_ROWS = [  # mesh axes, global batch, microbatch, overlap
    (dict(data=2), 8, 1, True), (dict(data=2), 8, 2, True), (dict(data=2), 8, 3, True),
    (dict(data=2), 8, 1, False), (dict(data=4), 8, 1, True), (dict(data=2), 7, 1, True),
]


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
@pytest.mark.parametrize("axes,gb,micro,overlap", PLAN_ROWS,
                         ids=[f"{a}-{g}-{m}-{o}" for a, g, m, o in PLAN_ROWS])
def test_moe_plan_rides_the_overlap_paths_as_in_jax(mode, axes, gb, micro, overlap):
    """An MoE plan reads JAX's strategy and fallback reason for every row
    the port runs: the overlap paths, not a forced fallback; no expert
    axis, so no ep_overlap."""
    world = int(np.prod(list(axes.values())))
    kw = dict(microbatch=micro, overlap=overlap, has_moe=True, n_experts=8)
    jp = JParallelPlan.make(FakeMesh(**axes), mode, gb, **kw)
    tp = ParallelPlan.make(world, mode, gb, **kw)
    assert (tp.grad_sync, tp.fallback_reason, tp.dp_size, tp.ep_engaged) == \
        (jp.grad_sync, jp.fallback_reason, jp.dp_size, jp.ep_engaged), jp.describe()
    assert tp.describe()["n_experts"] == 8 and tp.describe()["ep_engaged"] is False
    run = RunConfig(model=get_config("mixtral-8x7b"), shape=ShapeConfig("t", 32, gb, "train"),
                    sharding=mode, microbatch=micro)
    assert ParallelPlan.for_run(run, world, overlap=overlap) == tp


FUSED_CASES = {"micro1": (1, 8), "straddle": (3, 12)}   # name -> (microbatch, global batch)

FUSED_JAX_BODY = """
    import json, jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.distributed.sharding import ParallelPlan
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model
    from repro.train.train_step import init_state, make_grad_fn
    CFG
    out, S = OUT_PATH, 32
    cases = json.loads(CASES_JSON)
    model = build_model(cfg)
    mesh = make_host_mesh(2, 1)
    name = lambda p: '.'.join(str(getattr(k, 'key', getattr(k, 'idx', k))) for k in p)
    save, params = {}, None
    for case, (micro, B) in cases.items():
        rng = np.random.RandomState(2)
        toks = rng.randint(4, 256, (B, S)).astype(np.int32)
        mask = (rng.rand(B, S) > 0.2).astype(np.float32)
        save.update({case + '/tokens': toks, case + '/labels': np.roll(toks, -1, 1),
                     case + '/mask': mask})
        run = RunConfig(model=cfg, shape=ShapeConfig('t', S, B, 'train'), sharding='ddp',
                        param_dtype='float32', activation_dtype='float32', microbatch=micro)
        if params is None:
            params = init_state(model, jax.random.PRNGKey(0), run)['params']
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
                save['param/' + name(p)] = np.asarray(x)
        batch = {'tokens': jnp.asarray(toks), 'labels': jnp.asarray(np.roll(toks, -1, 1)),
                 'loss_mask': jnp.asarray(mask)}
        plan = ParallelPlan.for_run(run, mesh, overlap=False)
        save[case + '/grad_sync'] = np.asarray(plan.grad_sync)
        loss, grads, met = jax.jit(make_grad_fn(model, run, mesh, plan))(params, batch)
        save[case + '/loss'] = np.asarray(loss)
        save[case + '/aux_loss'] = np.asarray(met['aux_loss'])
        for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            save[case + '/grad/' + name(p)] = np.asarray(g)
    np.savez(out, **save)
"""

FUSED_WORKER = """
    import json, sys, numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed import maybe_initialize_distributed
    from repro_torch.distributed.sharding import ParallelPlan
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import init_state, make_grad_fn
    CFG
    ref, out, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    info = maybe_initialize_distributed('cpu')
    S = 32
    z = np.load(ref)
    model = build_model(cfg, device='cpu')
    model.load_jax_params({k[6:]: z[k] for k in z.files if k.startswith('param/')})
    calls, route = [], tmoe.route

    def tap(p, x, cfg, stat_reduce=None):
        w, idx, aux = route(p, x, cfg, stat_reduce=stat_reduce)
        calls.append((torch.is_grad_enabled(), idx.clone()))
        return w, idx, aux

    tmoe.route = tap
    save = {}
    for case, (micro, B) in cases.items():
        rows = slice(info.rank * B // 2, (info.rank + 1) * B // 2)
        batch = {'tokens': torch.from_numpy(z[case + '/tokens'][rows]),
                 'labels': torch.from_numpy(z[case + '/labels'][rows]),
                 'loss_mask': torch.from_numpy(z[case + '/mask'][rows])}
        run = RunConfig(model=cfg, shape=ShapeConfig('t', S, B, 'train'), sharding='ddp',
                        param_dtype='float32', activation_dtype='float32', microbatch=micro)
        plan = ParallelPlan.for_run(run, info.world, overlap=False)
        save[case + '/grad_sync'] = np.asarray(plan.grad_sync)
        state = init_state(model, run, seed=None)
        calls.clear()
        loss, grads, met = make_grad_fn(model, run, plan)(state['params'], batch)
        pre = [i for g, i in calls if not g]
        grad = [i for g, i in calls if g]
        save[case + '/n_pre'] = np.asarray(len(pre))
        save[case + '/n_grad'] = np.asarray(len(grad))
        save[case + '/routes_equal'] = np.asarray(
            all(any(torch.equal(i, q) for q in pre) for i in grad)
            and all(any(torch.equal(q, i) for i in grad) for q in pre))
        save[case + '/loss'] = loss.detach().numpy()
        save[case + '/aux_loss'] = met['aux_loss'].numpy()
        for k, g in grads.items():
            save[case + '/grad/' + k] = g.detach().numpy().copy()
    np.savez(out, **save)
    torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fused_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_fused")
    ref = str(tmp / "jax.npz")
    cfg = textwrap.dedent(DP_CFG).strip().replace("\n", "\n    ")
    run_py(FUSED_JAX_BODY.replace("CFG", cfg).replace("OUT_PATH", repr(ref))
           .replace("CASES_JSON", repr(json.dumps(FUSED_CASES))), n_devices=2, timeout=400)
    spawn_ranks(tmp, FUSED_WORKER.replace("CFG", cfg),
                [ref, str(tmp / "rank{rank}.npz"), json.dumps(FUSED_CASES)], timeout=300)
    return dict(np.load(ref)), [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _fused_case_matches_jax(fused_runs, case):
    """Both ranks' loss, ``aux_loss`` and every gradient leaf within 1e-5
    of JAX's ``xla_fused`` step on a two-device mesh, and the routes of
    the no-grad pre-pass equal to those of the gradient pass (and its
    remat recompute): 2 MoE layers a piece."""
    z, ranks = fused_runs
    micro, B = FUSED_CASES[case]
    assert str(z[case + "/grad_sync"]) == "xla_fused"
    n_pieces = [sum(1 for m in range(micro)
                    if max(m * B // micro, r * B // 2) < min((m + 1) * B // micro, (r + 1) * B // 2))
                for r in range(2)]
    for r, got in enumerate(ranks):
        assert str(got[case + "/grad_sync"]) == "xla_fused"
        assert int(got[case + "/n_pre"]) == 2 * n_pieces[r]
        assert int(got[case + "/n_grad"]) >= 2 * n_pieces[r]
        assert bool(got[case + "/routes_equal"])
        np.testing.assert_allclose(float(got[case + "/loss"]), float(z[case + "/loss"]),
                                   rtol=LOSS_REL)
        np.testing.assert_allclose(float(got[case + "/aux_loss"]),
                                   float(z[case + "/aux_loss"]), rtol=LOSS_REL)
        keys = [k for k in z if k.startswith(case + "/grad/")]
        assert len(keys) == len([k for k in got if k.startswith(case + "/grad/")])
        worst = {k: _leaf_err(got[k], z[k]) for k in keys}
        assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    return n_pieces


def test_fused_fallback_refuses_moe_over_ranks(fused_runs):
    """ROADMAP C16, repaired: the ``xla_fused`` fallback (overlap off) over
    two gloo ranks computes JAX's step for an MoE model at microbatch 1,
    whose one global microbatch spans both ranks' rows: each rank's piece
    sees the microbatch's whole router statistics from a no-grad pre-pass
    and one all-reduce (``_fused_accum``).  The plan over one process
    still syncs nothing and trains, and a dense model's step builds."""
    assert _fused_case_matches_jax(fused_runs, "micro1") == [1, 1]
    _, tcfg = moe_cfgs("mixtral-8x7b", d_model=64)
    model = build_model(tcfg, device="cpu")
    run = RunConfig(model=tcfg, shape=ShapeConfig("t", 32, 8, "train"), sharding="ddp",
                    param_dtype="float32", activation_dtype="float32")
    plan = ParallelPlan.for_run(run, 2, overlap=False)
    assert plan.grad_sync == "xla_fused" and plan.has_moe
    tts.make_train_step(model, run, toptim.AdamWConfig(), plan)
    tts.make_grad_fn(model, run, ParallelPlan.for_run(run.with_(microbatch=3), 2))
    assert ParallelPlan.for_run(run, None, overlap=False).grad_sync == "none"
    tts.make_train_step(model, run, toptim.AdamWConfig(), ParallelPlan.for_run(run, None))
    dense = dataclasses.replace(reduced(get_config("llama3-8b"), d_model=64))
    drun = run.with_(model=dense)
    tts.make_train_step(build_model(dense, device="cpu"), drun, toptim.AdamWConfig(),
                        ParallelPlan.for_run(drun, 2, overlap=False))


def test_fused_fallback_moe_straddling_microbatches_match_jax(fused_runs):
    """The same at 3 global microbatches of 4 rows over two ranks of 6:
    the middle one straddles the ranks' rows (rank 0 holds 2 pieces, rank
    1 holds 2), the others lie on one rank each."""
    assert _fused_case_matches_jax(fused_runs, "straddle") == [2, 2]


DP_B, DP_S = 8, 32
# name -> (sharding, microbatch)
DP_CASES = {"ddp_micro1": ("ddp", 1), "ddp_micro2": ("ddp", 2), "fsdp_micro1": ("fsdp", 1)}

DP_CFG = """
    import dataclasses
    from repro.configs import get_config, reduced
    from repro.configs.base import ATTN, LayerSpec, uniform_schedule
    cfg = reduced(get_config('mixtral-8x7b'), d_model=64)
    cfg = dataclasses.replace(cfg, schedule=uniform_schedule(2, LayerSpec(kind=ATTN, moe=True)),
                              moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2),
                              vocab_size=256, max_position=32)
"""

JAX_DP_BODY = """
    import json, jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.distributed.sharding import ParallelPlan
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model
    from repro.train.train_step import init_state, make_grad_fn
    CFG
    out, B, S = OUT_PATH, 8, 32
    cases = json.loads(CASES_JSON)
    model = build_model(cfg)
    mesh = make_host_mesh(2, 1)
    rng = np.random.RandomState(1)
    toks = rng.randint(4, 256, (B, S)).astype(np.int32)
    mask = (rng.rand(B, S) > 0.2).astype(np.float32)
    name = lambda p: '.'.join(str(getattr(k, 'key', getattr(k, 'idx', k))) for k in p)
    save = {'tokens': toks, 'labels': np.roll(toks, -1, 1), 'mask': mask}
    params = None
    for case, (sharding, micro) in cases.items():
        run = RunConfig(model=cfg, shape=ShapeConfig('t', S, B, 'train'), sharding=sharding,
                        param_dtype='float32', activation_dtype='float32', microbatch=micro)
        if params is None:
            params = init_state(model, jax.random.PRNGKey(0), run)['params']
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
                save['param/' + name(p)] = np.asarray(x)
        batch = {'tokens': jnp.asarray(toks), 'labels': jnp.asarray(np.roll(toks, -1, 1)),
                 'loss_mask': jnp.asarray(mask)}
        plan = ParallelPlan.for_run(run, mesh, grad_bucket_mb=0.05)
        save[case + '/grad_sync'] = np.asarray(plan.grad_sync)
        loss, grads, met = jax.jit(make_grad_fn(model, run, mesh, plan))(params, batch)
        save[case + '/loss'] = np.asarray(loss)
        save[case + '/aux_loss'] = np.asarray(met['aux_loss'])
        for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            save[case + '/grad/' + name(p)] = np.asarray(g)
    np.savez(out, **save)
"""

DP_WORKER = """
    import json, sys, numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed import gradsync, maybe_initialize_distributed
    from repro_torch.distributed.sharding import ParallelPlan
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import init_state, make_grad_fn, shard_state
    CFG
    ref, out, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    info = maybe_initialize_distributed('cpu')
    B, S = 8, 32
    z = np.load(ref)
    model = build_model(cfg, device='cpu')
    model.load_jax_params({k[6:]: z[k] for k in z.files if k.startswith('param/')})
    rows = slice(info.rank * 4, (info.rank + 1) * 4)
    batch = {'tokens': torch.from_numpy(z['tokens'][rows]),
             'labels': torch.from_numpy(z['labels'][rows]),
             'loss_mask': torch.from_numpy(z['mask'][rows])}
    save = {}
    for case, (sharding, micro) in cases.items():
        run = RunConfig(model=cfg, shape=ShapeConfig('t', S, B, 'train'), sharding=sharding,
                        param_dtype='float32', activation_dtype='float32', microbatch=micro)
        plan = ParallelPlan.for_run(run, info.world, grad_bucket_mb=0.05)
        save[case + '/grad_sync'] = np.asarray(plan.grad_sync)
        state = init_state(model, run, seed=None)
        if sharding == 'fsdp':
            state = shard_state(state, plan.shard_layout(model, info.rank))
        else:
            save[case + '/n_buckets'] = np.asarray(len(plan.grad_buckets(model)))
        gf = make_grad_fn(model, run, plan)
        gradsync.reset_counts()
        loss, grads, met = gf(state['params'], batch)
        for k in ('router_stat_all_reduce', 'grad_all_reduce', 'grad_all_gather'):
            save[case + '/count/' + k] = np.asarray(gradsync.counts[k])
        save[case + '/loss'] = loss.detach().numpy()
        save[case + '/aux_loss'] = met['aux_loss'].numpy()
        for k, g in grads.items():
            save[case + '/grad/' + k] = g.detach().numpy().copy()
    np.savez(out, **save)
    torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_dp")
    ref = str(tmp / "jax.npz")
    cfg = textwrap.dedent(DP_CFG).strip().replace("\n", "\n    ")
    run_py(JAX_DP_BODY.replace("CFG", cfg).replace("OUT_PATH", repr(ref))
           .replace("CASES_JSON", repr(json.dumps(DP_CASES))), n_devices=2, timeout=400)
    spawn_ranks(tmp, DP_WORKER.replace("CFG", cfg),
                [ref, str(tmp / "rank{rank}.npz"), json.dumps(DP_CASES)], timeout=300)
    return dict(np.load(ref)), [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("case", list(DP_CASES))
def test_two_ranks_equal_jax_with_the_router_stats_reduced(dp_runs, case):
    """Two gloo ranks (4 rows each) under ddp and fsdp against JAX's
    two-device step (its ``route(stat_axes=...)``): the loss, the global
    ``aux_loss`` and every gradient leaf within 1e-5 of the leaf's
    largest value.  A microbatch's router statistics are averaged over
    the ranks once a MoE layer in its forward, again in the remat
    recompute, and once in its backward: 6 a microbatch at 2 layers; the
    gradient sync keeps its own counts (one all-reduce a bucket, ddp)."""
    z, ranks = dp_runs
    sharding, micro = DP_CASES[case]
    want_sync = GRAD_SYNC_SCATTER if sharding == "fsdp" else GRAD_SYNC_BUCKETED
    assert str(z[case + "/grad_sync"]) == want_sync
    for r in ranks:
        assert str(r[case + "/grad_sync"]) == want_sync
        assert int(r[case + "/count/router_stat_all_reduce"]) == 6 * micro
        if sharding == "ddp":
            assert int(r[case + "/count/grad_all_reduce"]) == int(r[case + "/n_buckets"]) > 1
        np.testing.assert_allclose(float(r[case + "/loss"]), float(z[case + "/loss"]),
                                   rtol=LOSS_REL)
        np.testing.assert_allclose(float(r[case + "/aux_loss"]), float(z[case + "/aux_loss"]),
                                   rtol=LOSS_REL)
        keys = [k for k in z if k.startswith(case + "/grad/")]
        assert len(keys) == len([k for k in r if k.startswith(case + "/grad/")])
        worst = {k: _leaf_err(r[k], z[k]) for k in keys}
        assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_train_cli_first_loss_is_the_jax_loss_on_its_batch(arch, tmp_path, one_thread):
    """``main --arch ARCH --reduced`` trains from its seed-0 parameters;
    its first loss (the next-token loss plus the aux) equals the JAX
    ``loss_for`` of those parameters on the pipeline's first batch with
    the launcher's rolled labels."""
    data = str(tmp_path / "data")
    argv = ["--device", "cpu", "--reduced", "--arch", arch, "--batch", "4", "--seq", "48",
            "--n-functions", "150", "--workers", "2", "--log-every", "1", "--steps", "2",
            "--data-dir", data]
    _, log = cli.main(argv)
    cfg = dataclasses.replace(reduced(get_config(arch)), max_position=4096)
    pipe = DataPipeline.build(data, n_functions=150, seq_len=48, batch_size=4,
                              vocab_size=cfg.vocab_size, work_fn=cli.make_work_fn(cfg))
    try:
        first = pipe.peek_batch(0)
    finally:
        pipe.close()
    assert np.array_equal(first["labels"].numpy(), np.roll(first["tokens"].numpy(), -1, 1))
    model = Model(cfg, seed=0, device="cpu")
    jparams = tree_map_paths(lambda path, _: jnp.asarray(model.state_dict()[path].numpy()),
                             model.specs())
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), max_position=4096)
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("cli", 48, 4, "train"), sharding="ddp",
                      param_dtype="float32", activation_dtype="float32")
    jloss, jmet = jts.loss_for(jbuild_model(jcfg), jparams,
                               {k: jnp.asarray(v.numpy(), jnp.int32 if k != "loss_mask"
                                               else jnp.float32) for k, v in first.items()},
                               run=jrun)
    assert float(jmet["aux_loss"]) > 0
    np.testing.assert_allclose(log.metrics[0]["loss"], float(jloss), rtol=LOSS_REL)
    assert log.metrics[1]["loss"] != log.metrics[0]["loss"]


@pytest.mark.parametrize("arch", MOE)
def test_launchers_refuse_the_jax_default_sharding_and_expert_parallel(arch, capsys):
    """The JAX package trains both MoE models under fsdp_tp by default,
    and has an expert-parallel flag; the port's launcher refuses both
    with their ROADMAP item."""
    for argv, msg in ((["--sharding", "fsdp_tp"], "--sharding fsdp_tp is not ported yet "
                                                   "(ROADMAP A11)"),
                      (["--expert-parallel"], "--expert-parallel is not ported yet "
                                              "(ROADMAP A11)")):
        with pytest.raises(SystemExit) as e:
            cli.main(["--arch", arch, "--device", "cpu", *argv])
        assert e.value.code == 2
        assert msg in capsys.readouterr().err


@pytest.mark.parametrize("arch", MOE)
def test_serve_cli_runs_the_reduced_model(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --reduced --paged
    --arch ARCH``: 4 requests, greedy tokens inside the vocabulary."""
    serve_cli.main(["--device", "cpu", "--reduced", "--paged", "--arch", arch,
                    "--prompt-len", "20", "--max-new", "6"])
    out = capsys.readouterr().out
    assert f"[serve] {get_config(arch).name}-smoke paged on cpu: 4 requests x 20 prompt " \
           f"+ 6 new" in out

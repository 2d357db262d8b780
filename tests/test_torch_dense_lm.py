"""The port's llama3-8b and qwen2-72b slices, and bert-mlm-350m, against the
JAX package on the CPU, in f32: the configs field for field at full size
and reduced, and their parameter counts; the untied ``lm_head`` and
qwen2's qkv bias under RMSNorm carried over from JAX parameters; the
logits in train and prefill mode (JAX with its Pallas flash kernel in
interpret mode, and with its jnp attention); the paged engine's tokens and
logits; the next-token loss and every gradient leaf (``lm_head``, ``bq``,
``bk`` and ``bv`` among them) at microbatch 1 and 2; a 20-step trajectory
on the launcher's rolled labels (ROADMAP C13); bert-mlm-350m's MLM loss
and gradients; and the train CLI's first loss for all three.

The test models are the reduced configs (``configs.base.reduced``) at 2
layers, built in both packages by ``dataclasses.replace``, with the GQA
ratio of the full model kept: llama3 8 q heads over 2 kv heads of 64
(rep 4, as its 32 / 8), qwen2 8 over 1 (rep 8, as its 64 / 8).  Inputs
come from numpy seeds and go to both packages."""
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
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch.configs import default_run_config, get_config, list_archs, reduced
from repro_torch.configs.base import LayerSpec, ShapeConfig, uniform_schedule
from repro_torch.core import scaling
from repro_torch.core.accum import accumulate_grads
from repro_torch.data import DataPipeline
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as cli
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import flatten_tree, tree_map_paths
from repro_torch.serve.engine import PagedServeEngine
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts

import test_torch_train as bert
from test_torch_gemma2 import ENGINE_KW, MAX_NEW, _drive
from test_torch_gemma_train import _batch, _jbatch, _leaf_err, _runs, _tbatch, one_thread  # noqa: F401
from test_torch_train import TRAJ_REL

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-5)          # f32 on both sides, summed in other orders
LOSS_REL = 1e-5
DENSE = ("llama3-8b", "qwen2-72b")
# the reduced models' attention: the full model's GQA ratio kept
HEADS = {"llama3-8b": dict(n_heads=8, n_kv_heads=2, head_dim=64),
         "qwen2-72b": dict(n_heads=8, n_kv_heads=1, head_dim=64)}
PARAMS = {"bert-mlm-350m": 337_449_984, "llama3-8b": 8_030_261_248,
          "qwen2-72b": 72_706_203_648}
# bert's key bias has an exact gradient of 0 (it adds q.bk to every
# score of a row; the softmax is invariant to that): both packages
# return f32 rounding noise, held to 0 at the scale of the key
# projection's gradient.  qwen2's is not: rope turns bk by each key's
# position, so it moves the scores of a row apart.
ZERO_GRAD = {"groups.0.0.mixer.bk": "groups.0.0.mixer.wk"}


def dense_cfgs(arch):
    """(JAX, port) configs of the reduced ``arch`` at 2 layers, the full
    model's GQA ratio kept."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), schedule=juniform(2, JLayerSpec()),
                               **HEADS[arch])
    tcfg = dataclasses.replace(reduced(get_config(arch)), schedule=uniform_schedule(2, LayerSpec()),
                               **HEADS[arch])
    return jcfg, tcfg


_MODELS = {}


def models(arch):
    """One JAX-initialised parameter set in both packages, built once per
    arch; the norm scales (ones at init) re-drawn around 1 and the qkv
    biases (zeros at init) around 0, so that every leaf carries
    information."""
    if arch not in _MODELS:
        jcfg, tcfg = dense_cfgs(arch)
        jmodel = jbuild_model(jcfg)
        params = jax.tree_util.tree_map(np.array, jmodel.init(jax.random.PRNGKey(3)))
        rng = np.random.RandomState(3)
        for path, a in flatten_tree(params).items():
            leaf = path.rsplit(".", 1)[-1]
            if leaf == "scale":
                a[...] = 1.0 + 0.2 * rng.standard_normal(a.shape)
            elif leaf in ("bq", "bk", "bv"):
                a[...] = 0.1 * rng.standard_normal(a.shape)
        tmodel = build_model(tcfg, device="cpu")
        tmodel.load_jax_params(params)
        _MODELS[arch] = (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel)
    return _MODELS[arch]


def _tokens(jcfg, S, seed):
    return np.random.RandomState(seed).randint(4, jcfg.vocab_size, (1, S)).astype(np.int32)


def _cache_leaves(tree):
    return {f"{pi}.{name}": leaf for pi, layer in enumerate(tree["groups"][0])
            for name, leaf in layer["mixer"].items()}


# ---------------------------------------------------------------------------
# the configs and the parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ["bert-mlm-350m", *DENSE])
def test_config_matches_jax_field_for_field(arch, size):
    """Each of the three archs in the port's registry equals the JAX
    package's config in every field, at full size and reduced."""
    assert arch in list_archs()
    tcfg, jcfg = get_config(arch), jget_config(arch)
    if size == "reduced":
        tcfg, jcfg = reduced(tcfg), jreduced(jcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if size == "full" and arch in DENSE:
        assert not tcfg.tie_embeddings and tcfg.norm == "rmsnorm"
        assert tcfg.qkv_bias == (arch == "qwen2-72b")
        assert tcfg.n_heads // tcfg.n_kv_heads == {"llama3-8b": 4, "qwen2-72b": 8}[arch]


@pytest.mark.parametrize("arch", ["bert-mlm-350m", *DENSE])
def test_param_count_matches_jax(arch):
    """The exact count from the spec tree, equal to JAX's: llama3-8b and
    qwen2-72b with their untied ``lm_head`` (d x V)."""
    n = scaling.param_count(get_config(arch))
    assert n == jscaling.param_count(jget_config(arch)) == PARAMS[arch]
    assert scaling.model_flops(get_config(arch), 10) == 60.0 * n


@pytest.mark.parametrize("arch", DENSE)
def test_from_jax_params_round_trips(arch):
    """Every leaf, the untied ``embed.lm_head`` (d, V) and, for qwen2, the
    qkv biases, loads bit for bit from the JAX tree."""
    jcfg, _, params, tmodel = models(arch)
    flat = flatten_tree(jax.tree_util.tree_map(np.array, params))
    sd = tmodel.state_dict()
    assert sorted(sd) == sorted(flat)
    assert sd["embed.lm_head"].shape == (jcfg.d_model, jcfg.vocab_size)
    biases = {f"groups.0.0.mixer.{b}" for b in ("bq", "bk", "bv")}
    assert (biases <= set(sd)) == (arch == "qwen2-72b")
    if arch == "qwen2-72b":
        assert sd["groups.0.0.mixer.bk"].shape == (2, 1, 64)
    for k, a in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)


# ---------------------------------------------------------------------------
# the forward: train logits, prefill, the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_train_logits_match_jax(arch):
    """The whole model in train mode: rope at the model's theta, GQA at
    rep 4 or 8, the untied unembedding."""
    jcfg, jmodel, params, tmodel = models(arch)
    toks = _tokens(jcfg, 45, 3)
    want, _, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.no_grad():
        got, _, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()}, mode="train")
    assert got.shape == (1, 45, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("S,L,use_pallas", [(40, 40, False), (128, 128, True),
                                            (128, 101, True)])
def test_prefill_matches_jax(arch, S, L, use_pallas):
    """A prompt of L tokens right-padded to S: the hidden state and both
    layers' K/V caches, and for an unpadded prompt the prefill's logits
    (the last position's, through ``lm_head``); at S 128 the JAX side runs
    its Pallas flash kernel in interpret mode."""
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
        assert tl.shape == (1, 1, jcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl).reshape(tl.shape), **TOL)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_matches_jax_tokens_and_logits(arch, use_pallas):
    """The paged engines of both packages on the same staggered requests
    (prompts of 70, 13, 100 and 5 tokens, 12 new each, 3 slots): the same
    greedy tokens, and every prefill's and decode tick's logits within
    TOL; JAX with its Pallas flash and paged kernels in interpret mode, or
    its jnp oracles."""
    jcfg, jmodel, params, tmodel = models(arch)
    run = JRunConfig(model=jcfg, shape=JShapeConfig("s", 16, 2, "decode"), sharding="ddp",
                     param_dtype="float32", activation_dtype="float32", use_pallas=use_pallas)
    jeng = JPagedServeEngine(model=jmodel, run=run, use_pallas_decode=use_pallas, **ENGINE_KW)
    want_tokens, want_log = _drive(jeng, lambda: jeng.step(params), jcfg)
    eng = PagedServeEngine(tmodel, default_run_config(tmodel.cfg,
                                                      ShapeConfig("s", 16, 2, "decode")),
                           **ENGINE_KW)
    got_tokens, got_log = _drive(eng, eng.step, jcfg)
    assert got_tokens == want_tokens
    assert [k for k, _ in got_log] == [k for k, _ in want_log]
    assert sum(k == "decode" for k, _ in got_log) > MAX_NEW
    for i, ((kind, got), (_, want)) in enumerate(zip(got_log, want_log)):
        np.testing.assert_allclose(got, want, err_msg=f"{kind} {i}", **TOL)


# ---------------------------------------------------------------------------
# training: the loss, every gradient leaf, 20 steps
# ---------------------------------------------------------------------------


def _grad_errors(tgrads, jgrads, zero=()):
    """{leaf: error over its limit} (<= 1 passes) for every leaf; those of
    ``zero`` (ZERO_GRAD's keys) held to 0 at their reference's scale."""
    jflat = flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(tgrads)
    worst = {k: _leaf_err(tgrads[k].numpy(), w) for k, w in jflat.items() if k not in zero}
    for k in zero:
        lim = bert.LEAF_REL * float(np.abs(jflat[ZERO_GRAD[k]]).max())
        worst[k] = max(float(np.abs(jflat[k]).max()), tgrads[k].abs().max().item()) / lim
    return worst


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_loss_and_every_grad_leaf_match_jax(arch, microbatch, use_pallas):
    """The next-token loss on the launcher's rolled labels (the last row
    partly padding), its metrics and every gradient leaf (``lm_head``,
    the qkv biases, the GQA backward at rep 4 or 8 through
    rematerialised layers, the chunked loss) against
    ``jax.value_and_grad`` of the JAX ``loss_for``, accumulated over the
    microbatches; JAX with its Pallas flash and xent in interpret mode
    (``use_pallas``) or its jnp attention."""
    jcfg, jmodel, params, tmodel = models(arch)
    jrun, trun = _runs(jcfg, tmodel.cfg, use_pallas, microbatch=microbatch)
    b = _batch(4, jcfg.vocab_size)
    jloss, jgrads, jmet = jaccumulate(
        lambda p, bb: jts.loss_for(jmodel, p, bb, run=jrun), params, _jbatch(b), microbatch)
    state = tts.init_state(tmodel, trun, seed=None)
    tloss, tgrads, tmet = accumulate_grads(
        lambda p, bb: tts.loss_for(tmodel, p, bb, run=trun), state["params"], _tbatch(b),
        microbatch)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_REL)
    for k in ("xent", "acc", "tokens", "loss"):
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=LOSS_REL, atol=1e-7,
                                   err_msg=k)
    assert tgrads["embed.lm_head"].abs().max() > 0
    if arch == "qwen2-72b":       # rope gives the key bias a gradient of its own
        assert tgrads["groups.0.0.mixer.bk"].abs().max() > 1e-3 * tgrads[
            "groups.0.0.mixer.wk"].abs().max()
    worst = _grad_errors(tgrads, jgrads)
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("arch", DENSE)
def test_20_step_trajectory_matches_jax(arch):
    """Both packages' train steps (remat, chunked next-token loss on the
    rolled labels, AdamW) on the same 20 batches, JAX with its jnp
    attention; the loss falls and follows JAX at TRAJ_REL."""
    jcfg, jmodel, params, tmodel = models(arch)
    jrun, trun = _runs(jcfg, tmodel.cfg)
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=20, weight_decay=0.1)
    jstep = jax.jit(jts.make_train_step(jmodel, jrun, joptim.AdamWConfig(**opt)))
    # the port's step updates the parameters in place: it trains a copy
    jstate = {"params": params, "opt": joptim.init_opt_state(params)}
    tmodel2 = build_model(tmodel.cfg, device="cpu")
    tmodel2.load_state_dict(tmodel.state_dict())
    tstep = tts.make_train_step(tmodel2, trun, toptim.AdamWConfig(**opt))
    tstate = tts.init_state(tmodel2, trun, seed=None)
    jl, tl = [], []
    for i in range(20):
        b = _batch(100 + i, jcfg.vocab_size)
        jstate, jm = jstep(jstate, _jbatch(b))
        tstate, tm = tstep(tstate, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)


# ---------------------------------------------------------------------------
# bert-mlm-350m: the MLM loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bert350():
    """The reduced bert-mlm-350m at 2 layers in both packages, the biases
    and norm parameters re-drawn (JAX inits them to 0 / 1)."""
    jcfg = dataclasses.replace(jreduced(jget_config("bert-mlm-350m")),
                               schedule=juniform(2, JLayerSpec()))
    tcfg = dataclasses.replace(reduced(get_config("bert-mlm-350m")),
                               schedule=uniform_schedule(2, LayerSpec()))
    jmodel = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(np.array, jmodel.init(jax.random.PRNGKey(4)))
    rng = np.random.RandomState(4)
    for path, a in flatten_tree(params).items():
        if path.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "bi", "bo", "bias", "scale",
                                       "out_bias"):
            a[...] = (1.0 if path.endswith("scale") else 0.0) \
                + 0.1 * rng.standard_normal(a.shape)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_jax_params(params)
    return jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel


@pytest.mark.parametrize("microbatch", [1, 2])
def test_bert350_mlm_loss_and_every_grad_leaf_match_jax(bert350, microbatch):
    """The MLM loss on a BERT-masked batch (numpy), its metrics and every
    gradient leaf of the reduced bert-mlm-350m (its LayerNorm eps 1e-12,
    the tied MLM head) against the JAX ``loss_for``."""
    jcfg, jmodel, params, tmodel = bert350
    jrun, trun = bert._runs(jcfg, tmodel.cfg, microbatch=microbatch)
    b = bert._batch(4, jcfg.vocab_size)
    jloss, jgrads, jmet = jaccumulate(
        lambda p, bb: jts.loss_for(jmodel, p, bb, run=jrun), params, bert._jbatch(b),
        microbatch)
    state = tts.init_state(tmodel, trun, seed=None)
    tloss, tgrads, tmet = accumulate_grads(
        lambda p, bb: tts.loss_for(tmodel, p, bb, run=trun), state["params"],
        bert._tbatch(b), microbatch)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_REL)
    for k in ("xent", "acc", "tokens", "loss"):
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=LOSS_REL, atol=1e-7,
                                   err_msg=k)
    worst = _grad_errors(tgrads, jgrads, zero=ZERO_GRAD)
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["bert-mlm-350m", *DENSE])
def test_train_cli_first_loss_is_the_jax_loss_on_its_batch(arch, tmp_path, one_thread):
    """``main --arch ARCH --reduced`` trains from its seed-0 parameters;
    its first loss equals the JAX ``loss_for`` of those parameters on the
    pipeline's first batch (for the decoders the launcher's labels: the
    tokens rolled by one and the attention mask as the loss mask; for
    bert BERT masks)."""
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
    if arch in DENSE:
        assert np.array_equal(first["labels"].numpy(), np.roll(first["tokens"].numpy(), -1, 1))
    model = Model(cfg, seed=0, device="cpu")
    jparams = tree_map_paths(lambda path, _: jnp.asarray(model.state_dict()[path].numpy()),
                             model.specs())
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), max_position=4096)
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("cli", 48, 4, "train"), sharding="ddp",
                      param_dtype="float32", activation_dtype="float32")
    jloss, _ = jts.loss_for(jbuild_model(jcfg), jparams,
                            {k: jnp.asarray(v.numpy(), jnp.int32 if k != "loss_mask"
                                            else jnp.float32) for k, v in first.items()},
                            run=jrun)
    np.testing.assert_allclose(log.metrics[0]["loss"], float(jloss), rtol=LOSS_REL)
    assert log.metrics[1]["loss"] != log.metrics[0]["loss"]


@pytest.mark.parametrize("arch", DENSE)
def test_train_cli_refuses_the_jax_default_sharding(arch, capsys):
    """The JAX package trains llama3-8b and qwen2-72b under fsdp_tp by
    default; the port's launcher refuses it with its ROADMAP item."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--arch", arch, "--sharding", "fsdp_tp", "--device", "cpu"])
    assert e.value.code == 2
    assert "--sharding fsdp_tp is not ported yet (ROADMAP A11)" in capsys.readouterr().err


@pytest.mark.parametrize("arch", DENSE)
def test_serve_cli_runs_the_reduced_model(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --reduced --paged
    --arch ARCH``: 4 requests, greedy tokens inside the vocabulary."""
    serve_cli.main(["--device", "cpu", "--reduced", "--paged", "--arch", arch,
                    "--prompt-len", "20", "--max-new", "6"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}-smoke paged on cpu: 4 requests x 20 prompt + 6 new" in out

"""The port's zamba2-2.7b slice against the JAX package on the CPU, in f32:
the config field for field and its parameter count; the two weight-shared
attention banks (their stacked positions own no parameters, each
invocation reads its bank's one set of leaves); the train forward, the
prefill and paged decode (JAX with its Pallas kernels in interpret mode,
and with its jnp oracles); the paged engine's tokens and logits; the
next-token loss and every gradient leaf, the banks' included, at
microbatch 1 and 2; a 5-step ``trainer.train`` trajectory; the plain
flash forward, flash backward and paged attention at head dim 80 against
the Pallas kernels in interpret mode; and the CUDA sources' head-dim-80
layout, read as text.

The test model is a reduced zamba2 built identically in both packages
by ``dataclasses.replace`` of each package's own config: d_model 320, 4
MHA heads of 80 (zamba2's head dim), the SSM block unchanged in kind
(d_state 64, head_dim 64, one group; chunk 32, so that prompts span
chunks), the schedule (M, A, M, B) x 2, so that each bank runs twice;
vocab 1024 and d_ff 640 keep it quick.  ``reduced()`` is not used: it
keeps bank A alone and head dim 64.  Inputs come from numpy seeds and go
to both packages."""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ScheduleGroup as JScheduleGroup
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.accum import accumulate_grads as jaccumulate
from repro.core.scaling import param_count as jparam_count
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_fwd as jflash_fwd
from repro.kernels.paged_attention import paged_attention_fwd as jpaged_fwd
from repro.models.transformer import model_specs as jmodel_specs
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import paged_cache as jpaged
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch.configs import default_run_config, get_config, list_archs
from repro_torch.configs.base import SHARED_ATTN, ScheduleGroup, ShapeConfig
from repro_torch.core.accum import accumulate_grads
from repro_torch.core.scaling import param_count
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import paged_attention as tpaged_kernel
from repro_torch.models import blocks, transformer
from repro_torch.models.model import build_model
from repro_torch.models.params import flatten_tree
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve.engine import PagedServeEngine
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import train

from test_torch_gemma import gemma_params
from test_torch_gemma2 import ENGINE_KW, MAX_NEW, _drive
from test_torch_gemma_train import _batch, _jbatch, _leaf_err, _runs, _tbatch
from test_torch_train import TRAJ_REL

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-5)          # f32 on both sides, summed in other orders
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)    # the JAX flash and paged tests' f32 bar
LOSS_REL = 1e-5
D = 80                                    # zamba2-2.7b's head dim


def _cut(cfg, group_cls):
    """``cfg`` (either package's zamba2-2.7b) at d_model 320, 4 MHA heads
    of 80, chunk 32, vocab 1024, d_ff 640, the schedule (M, A, M, B) x 2."""
    pattern = cfg.schedule[0].pattern
    M, A, B = pattern[0], pattern[6], pattern[13]
    assert (A.shared_bank, B.shared_bank) == (0, 1)
    return dataclasses.replace(
        cfg, d_model=320, n_heads=4, n_kv_heads=4, head_dim=D, d_ff=640, vocab_size=1024,
        ssm=dataclasses.replace(cfg.ssm, chunk=32),
        schedule=(group_cls(pattern=(M, A, M, B), repeats=2),))


def zamba2_cfgs():
    return (_cut(jget_config("zamba2-2.7b"), JScheduleGroup),
            _cut(get_config("zamba2-2.7b"), ScheduleGroup))


_MODELS = {}


def models():
    """One JAX-initialised parameter set in both packages, built once: the
    norm scales and the SSM blocks' D and gate norm re-drawn around 1, so
    that each carries information, and the banks' attention projections
    at the scale the port draws them (``models/params.py:_fan_in``).  The
    JAX init gives those unstacked 3D leaves a fan-in of their second
    axis alone (wq (d, H, D): H), so q and k come out sqrt(d) times too
    large and the scores in the hundreds: the softmax then picks a key
    by f32 rounding, and JAX's own jnp and Pallas forwards differ by 8e-4
    of the largest logit on this model."""
    if not _MODELS:
        jcfg, tcfg = zamba2_cfgs()
        jmodel, params = gemma_params(jcfg, seed=3)
        rng = np.random.RandomState(4)
        for path, a in flatten_tree(params).items():
            if path.rsplit(".", 1)[-1] in ("D", "gate_norm"):
                a[...] = 1.0 + 0.3 * rng.standard_normal(a.shape)
            if path.startswith("shared.") and a.ndim == 3:
                a *= np.float32(a.shape[0] ** -0.5)
        tmodel = build_model(tcfg, device="cpu")
        tmodel.load_jax_params(params)
        _MODELS["m"] = (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel)
    return _MODELS["m"]


def _tokens(vocab, S, seed):
    return np.random.RandomState(seed).randint(4, vocab, (1, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# the config, the parameters and the shared banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "test"])
def test_config_matches_jax_field_for_field(size):
    """zamba2-2.7b in the port's registry equals the JAX package's config in
    every field (the schedule's layer specs and banks included), at full
    size and as this file's test model; its full size is (6 M, A, 6 M, B)
    x 4 + (6 M, A): 54 Mamba2 blocks and 9 invocations of two banks, 32
    MHA heads of 80."""
    assert "zamba2-2.7b" in list_archs()
    tcfg, jcfg = get_config("zamba2-2.7b"), jget_config("zamba2-2.7b")
    if size == "test":
        jcfg, tcfg = zamba2_cfgs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    kinds = [s.kind for g in tcfg.schedule for _ in range(g.repeats) for s in g.pattern]
    banks = [s.shared_bank for g in tcfg.schedule for _ in range(g.repeats)
             for s in g.pattern if s.kind == SHARED_ATTN]
    if size == "full":
        assert kinds.count("mamba") == 54 and banks == [0, 1] * 4 + [0]
        assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim) == (32, 32, 80)
    else:
        assert banks == [0, 1, 0, 1] and kinds.count("mamba") == 4


def test_param_count_matches_jax():
    """The full model's parameter count, from the spec tree, is the JAX
    package's: 2 445 329 568 (the banks counted once)."""
    cfg = get_config("zamba2-2.7b")
    assert param_count(cfg) == jparam_count(jget_config("zamba2-2.7b")) == 2_445_329_568


def test_zamba2_shared_banks_are_actually_shared():
    """The port's counterpart of the JAX package's test: two banks, A and
    B, and the stacked shared positions own no parameters (at full size);
    in the test model, perturbing bank 0 changes the output of every
    invocation of bank 0 and of none of bank 1, on a fixed input."""
    cfg = get_config("zamba2-2.7b")
    specs = transformer.model_specs(cfg)
    assert len(specs["shared"]) == 2
    assert specs["shared"][0].keys() == {"ln1", "mixer", "ln2", "mlp"}
    for gi, g in enumerate(cfg.schedule):
        for pi, spec in enumerate(g.pattern):
            if spec.kind == SHARED_ATTN:
                assert specs["groups"][gi][pi] == {}, "shared positions must not own parameters"
    jspecs = jmodel_specs(jget_config("zamba2-2.7b"))
    jshapes = flatten_tree(jax.tree_util.tree_map(lambda s: str(s.shape), jspecs,
                                                  is_leaf=lambda x: hasattr(x, "axes")))
    assert jshapes == {k: str(s.shape) for k, s in flatten_tree(specs).items()}
    jcfg, _, _, tmodel = models()
    tcfg = tmodel.cfg
    h = torch.from_numpy(np.random.RandomState(9).standard_normal((1, 20, tcfg.d_model))
                         .astype(np.float32))
    positions = torch.arange(20, dtype=torch.int32)[None]

    def invocations(shared):
        out = []
        for r in range(tcfg.schedule[0].repeats):
            for pi, spec in enumerate(tcfg.schedule[0].pattern):
                if spec.kind == SHARED_ATTN:
                    bp = blocks.layer_row(tmodel["groups"][0][pi], r)
                    assert bp == {}
                    y, _, _ = blocks.apply_block(bp, shared, h, tcfg, spec,
                                                 positions=positions, mode="train")
                    out.append((spec.shared_bank, y))
        return out

    with torch.no_grad():
        before = invocations(tmodel["shared"])
        banks = [dict(b.named_parameters()) for b in tmodel["shared"]]
        held = banks[0]["mixer.wq"].clone()
        banks[0]["mixer.wq"].add_(0.1)
        try:
            after = invocations(tmodel["shared"])
        finally:
            banks[0]["mixer.wq"].copy_(held)
    assert [b for b, _ in before] == [0, 1, 0, 1]
    for (bank, y0), (_, y1) in zip(before, after):
        assert torch.equal(y0, y1) == (bank == 1), bank
    # the two invocations of a bank on one input are one function
    assert torch.equal(before[0][1], before[2][1]) and torch.equal(before[1][1], before[3][1])


def test_from_jax_params_carries_the_banks_leaf_for_leaf():
    """Every leaf, the banks' ``shared.{0,1}.*`` among them, equal to
    JAX's; the stacked shared positions carry none."""
    jcfg, _, params, tmodel = models()
    flat = flatten_tree(jax.tree_util.tree_map(np.array, params))
    sd = tmodel.state_dict()
    assert sorted(sd) == sorted(flat)
    assert {"shared.0.mixer.wq", "shared.1.mlp.wo", "shared.1.ln2.scale"} <= set(sd)
    assert not any(k.startswith(("groups.0.1.", "groups.0.3.")) for k in sd)
    assert sd["shared.0.mixer.wq"].shape == (jcfg.d_model, jcfg.n_heads, D)
    for k, a in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)


# ---------------------------------------------------------------------------
# the forward, the prefill, decode and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,use_pallas", [(45, False), (128, True)])
def test_train_forward_matches_jax(S, use_pallas):
    """The whole model in train mode: 4 Mamba2 blocks and both banks twice
    each (JAX at S 128 with its Pallas flash and SSD kernels in interpret
    mode)."""
    jcfg, jmodel, params, tmodel = models()
    toks = _tokens(jcfg.vocab_size, S, S)
    want, _, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="train",
                              use_pallas=use_pallas)
    with torch.no_grad():
        got, _, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()}, mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _leaves(tree):
    """{"row.position.name": leaf} of a cache tree's stacked group 0."""
    return {f"{pi}.{name}": leaf for pi, layer in enumerate(tree["groups"][0])
            for name, leaf in layer["mixer"].items()}


@pytest.mark.parametrize("L,use_pallas", [(37, False), (128, True)])
def test_prefill_matches_jax(L, use_pallas):
    """A prompt of L tokens at its exact length (the SSM layers take no
    padding): the hidden state and every cache leaf, each invocation of a
    bank its own k and v beside the Mamba2 blocks' conv tails and f32
    state (JAX at L 128 with its Pallas kernels in interpret mode)."""
    jcfg, jmodel, params, tmodel = models()
    toks = _tokens(jcfg.vocab_size, L, L + 1)
    jh, jcache, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                 return_hidden=True, use_pallas=use_pallas)
    with torch.inference_mode():
        th, tcache, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()},
                                     mode="prefill", return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    want, got = _leaves(jcache), _leaves(tcache)
    assert sorted(got) == sorted(want)
    assert got["1.k"].shape == (2, 1, L, jcfg.n_kv_heads, D)      # bank A, twice
    assert got["0.state"].dtype == torch.float32
    for name, leaf in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(leaf), err_msg=name, **TOL)


def test_cache_shapes_give_each_invocation_its_own_kv():
    """At full size the pools hold 9 k/v caches (4 + 4 of the first group,
    1 of the last) and 54 SSM rows; the paged pools keep them per
    invocation, and the SSM leaves as per-slot rows."""
    cfg = get_config("zamba2-2.7b")
    shapes = transformer.cache_shapes(cfg, 1, 16)
    kv = [layer["mixer"]["k"][0] for g in shapes["groups"] for layer in g
          if "k" in layer["mixer"]]
    assert [s[0] for s in kv] == [4, 4, 1] and all(s[1:] == (1, 16, 32, 80) for s in kv)
    _, _, _, tmodel = models()
    pools = tpaged.build_pools(tmodel.cfg, page=8, n_pages=5, max_slots=3, device="cpu")
    layers = pools["groups"][0]
    assert layers[1]["mixer"]["k"].shape == (2, 5, 8, 4, D)
    assert layers[0]["mixer"]["state"].shape == (2, 3, 10, 64, 64)
    assert layers[0]["mixer"]["state"].dtype == torch.float32


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_matches_jax(use_pallas):
    """One slot prefilled with 8 tokens, then decoded through the paged
    step to position 39: every tick's logits (the banks' invocations
    through the paged kernel's plain version, the Mamba2 blocks by their
    step recurrence) against JAX's decode step, jitted (its paged kernel
    in interpret mode, or its jnp oracle); the last against the port's own
    full forward."""
    jcfg, jmodel, params, tmodel = models()
    page, n_pages, S0, total = 8, 12, 8, 40
    toks = _tokens(jcfg.vocab_size, total, 11)
    tables = np.zeros((2, 6), np.int32)
    tables[0, :5] = (3, 8, 1, 10, 5)
    jpools = jpaged.build_pools(jcfg, page=page, n_pages=n_pages, max_slots=2)
    tpools = tpaged.build_pools(tmodel.cfg, page=page, n_pages=n_pages, max_slots=2,
                                device="cpu")
    _, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :S0])})
    jpools = jpaged.commit_prefill(jpools, jc, jcfg, page=page, slot=0,
                                   pages=jnp.asarray(tables[0, :1]))
    with torch.inference_mode():
        _, tc = tmodel.prefill({"tokens": torch.from_numpy(toks[:, :S0]).long()})
        tpaged.commit_prefill(tpools, tc, tmodel.cfg, page=page, slot=0,
                              pages=torch.from_numpy(tables[0, :1]).long())
    jdecode = jax.jit(lambda prm, pools, tok, p, tb: jmodel.decode_step(
        prm, pools, tok, p, paged={"tables": tb, "page": page, "use_pallas": use_pallas}))
    tpg = {"tables": torch.from_numpy(tables), "page": page}
    for pos in range(S0, total):
        tok = np.array([[toks[0, pos]], [0]], np.int32)
        p = np.array([pos, 0], np.int32)
        jlogits, jpools = jdecode(params, jpools, jnp.asarray(tok), jnp.asarray(p),
                                  jnp.asarray(tables))
        with torch.inference_mode():
            tlogits, tpools = tmodel.decode_step(tpools, torch.from_numpy(tok).long(),
                                                 torch.from_numpy(p), paged=tpg)
        np.testing.assert_allclose(tlogits[:1].numpy(), np.asarray(jlogits)[:1],
                                   err_msg=f"pos {pos}", **TOL)
    with torch.no_grad():
        full, _, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()}, mode="train")
    np.testing.assert_allclose(tlogits[0, 0].numpy(), full[0, -1].numpy(), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_matches_jax_tokens_and_logits(use_pallas):
    """The paged engines of both packages on the same staggered requests
    (prompts of 70, 13, 100 and 5 tokens, each prefilled at its exact
    length; 3 slots, so the last waits): the same greedy tokens, and every
    prefill's and decode tick's logits within TOL; JAX with its Pallas
    flash, SSD and paged kernels in interpret mode, or its jnp oracles."""
    jcfg, jmodel, params, tmodel = models()
    run = JRunConfig(model=jcfg, shape=JShapeConfig("s", 16, 2, "decode"), sharding="ddp",
                     param_dtype="float32", activation_dtype="float32", use_pallas=use_pallas)
    jeng = JPagedServeEngine(model=jmodel, run=run, use_pallas_decode=use_pallas, **ENGINE_KW)
    want_tokens, want_log = _drive(jeng, lambda: jeng.step(params), jcfg)
    eng = PagedServeEngine(tmodel, default_run_config(tmodel.cfg,
                                                      ShapeConfig("s", 16, 2, "decode")),
                           **ENGINE_KW)
    assert eng._bucket(70) == 70                 # exact-length prefill
    got_tokens, got_log = _drive(eng, eng.step, jcfg)
    assert got_tokens == want_tokens
    assert [k for k, _ in got_log] == [k for k, _ in want_log]
    assert sum(k == "decode" for k, _ in got_log) > MAX_NEW
    for i, ((kind, got), (_, want)) in enumerate(zip(got_log, want_log)):
        np.testing.assert_allclose(got, want, err_msg=f"{kind} {i}", **TOL)


def test_launcher_cpu_subprocess_zamba2():
    """``launch.serve --device cpu --reduced --paged --arch zamba2-2.7b``:
    ``reduced`` keeps two Mamba2 blocks and bank A."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--reduced",
         "--paged", "--arch", "zamba2-2.7b", "--batch", "3", "--prompt-len", "40",
         "--max-new", "4"], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "zamba2-2.7b-smoke paged on cpu: 3 requests x 40 prompt + 4 new" in out.stdout


# ---------------------------------------------------------------------------
# training: the loss, every gradient leaf, 5 steps of trainer.train
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_loss_and_every_grad_leaf_match_jax(microbatch, use_pallas):
    """The next-token loss, its metrics and every gradient leaf against
    ``jax.value_and_grad`` of the JAX ``loss_for``, accumulated over the
    microbatches: each bank's leaves sum its two invocations (through
    rematerialised layers, the bank an input of each checkpoint), beside
    the Mamba2 blocks' SSD backward; JAX with its Pallas flash, SSD and
    xent in interpret mode (``use_pallas``) or its jnp versions."""
    jcfg, jmodel, params, tmodel = models()
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
    jflat = flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(tgrads)
    assert {"shared.0.mixer.wq", "shared.1.mlp.wo", "groups.0.0.mixer.A_log"} <= set(tgrads)
    worst = {k: _leaf_err(tgrads[k].numpy(), w) for k, w in jflat.items()}
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_remat_passes_the_banks_through_the_checkpoints():
    """The bank leaves' gradients (each the sum of its bank's two
    invocations) and every other leaf are the same whether each layer is
    rematerialised, the bank an input of its checkpoint, or not."""
    _, _, _, tmodel = models()
    trun = _runs(*zamba2_cfgs())[1]
    assert trun.remat
    b = _tbatch(_batch(5, tmodel.cfg.vocab_size))
    grads = {}
    for remat in (True, False):
        run = dataclasses.replace(trun, remat=remat)
        state = tts.init_state(tmodel, run, seed=None)
        _, grads[remat], _ = accumulate_grads(
            lambda p, bb: tts.loss_for(tmodel, p, bb, run=run), state["params"], b, 1)
    assert sorted(grads[True]) == sorted(grads[False])
    assert grads[True]["shared.0.mixer.wq"].abs().sum() > 0
    for k, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][k], rtol=1e-6, atol=1e-9, msg=k)


def test_5_step_trainer_trajectory_matches_jax():
    """``trainer.train`` (remat, chunked next-token loss, AdamW) on 5
    batches from the JAX-initialised state against the JAX train step,
    jitted, with its jnp attention and scan; the loss falls and follows
    JAX at TRAJ_REL."""
    jcfg, jmodel, params, tmodel = models()
    jrun, trun = _runs(jcfg, tmodel.cfg)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=5, weight_decay=0.1)
    jstep = jax.jit(jts.make_train_step(jmodel, jrun, joptim.AdamWConfig(**opt)))
    jstate = {"params": params, "opt": joptim.init_opt_state(params)}
    batches = [_batch(200 + i, jcfg.vocab_size) for i in range(5)]
    jl = []
    for b in batches:
        jstate, jm = jstep(jstate, _jbatch(b))
        jl.append(float(jm["loss"]))
    model = build_model(tmodel.cfg, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    tstate = tts.init_state(model, trun, seed=None)
    _, log = train(model, trun, toptim.AdamWConfig(**opt), iter(map(_tbatch, batches)),
                   steps=5, log_every=1, state=tstate)
    tl = [m["loss"] for m in log.metrics]
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)


# ---------------------------------------------------------------------------
# the kernels' plain versions at head dim 80
# ---------------------------------------------------------------------------


def _flash_inputs(seed, B, S, H, Hkv):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))


@pytest.mark.parametrize("causal,rep,window,softcap", [
    (True, 1, None, 0.0), (False, 1, None, 0.0), (True, 2, 40, 30.0)])
def test_flash_plain_matches_pallas_at_d80(causal, rep, window, softcap):
    """The plain flash forward at head dim 80 against the Pallas
    ``flash_attention_fwd`` in interpret mode (zamba2's MHA causal, and
    the kernel's other modes), at the JAX kernel tests' 2e-5."""
    q, k, v, _ = _flash_inputs(rep + 80, 2, 128, 2 * rep, 2)
    want = jflash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                      window=window, softcap=softcap, block_q=64, block_k=64, interpret=True)
    ops.reset_launch_counts()
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    assert not ops.launch_counts


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_plain_matches_jax_at_d80(causal):
    """dq, dk, dv of the plain version at head dim 80 (MHA, 4 heads)
    against the vjp of the JAX ``kops.flash_attention``, whose forward is
    the Pallas kernel in interpret mode, at 2e-5 of each gradient's
    scale."""
    q, k, v, w = _flash_inputs(81 + causal, 1, 128, 4, 4)
    fn = lambda q_, k_, v_: jops.flash_attention(q_, k_, v_, causal, None, 0.0, None)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    ops.reset_launch_counts()
    (ops.flash_attention(tq, tk, tv, causal) * torch.from_numpy(w)).sum().backward()
    for name, got, r in zip("qkv", (tq, tk, tv), want):
        scale_ = max(1.0, float(np.abs(np.asarray(r)).max()))
        np.testing.assert_allclose(got.grad.numpy() / scale_, np.asarray(r) / scale_,
                                   err_msg=name, **FLASH_TOL)
    assert not ops.launch_counts


@pytest.mark.parametrize("rep,window,softcap", [(1, None, 0.0), (1, 5, 30.0), (2, None, 0.0)])
def test_paged_plain_matches_pallas_at_d80(rep, window, softcap):
    """The plain paged decode at head dim 80 (rep 1, zamba2's) against the
    Pallas ``paged_attention_fwd`` in interpret mode: fragmented tables,
    trash page 0 past each allocation, ragged positions."""
    P, NP, maxp, B = 8, 32, 4, 5
    rng = np.random.RandomState(rep + 7)
    q = rng.standard_normal((B, 2 * rep, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((NP, P, 2, D)).astype(np.float32) for _ in range(2))
    perm = rng.permutation(np.arange(1, NP))
    tables = np.zeros((B, maxp), np.int32)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        n = 1 + b % maxp
        tables[b, :n] = perm[b * maxp:b * maxp + n]
        lens[b] = min(n * P - 1, (7 * (b + 1) + b * b) % (n * P))
    want = jpaged_fwd(*map(jnp.asarray, (q, kp, vp, tables, lens)), window=window,
                      softcap=softcap, interpret=True)
    ops.reset_launch_counts()
    got = ops.paged_attention(*map(torch.from_numpy, (q, kp, vp, tables, lens)),
                              window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    assert not ops.launch_counts


# ---------------------------------------------------------------------------
# the CUDA sources at head dim 80, read as text
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_zamba2", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_box_count_and_lane_split_is_guarded_for_d80():
    """No tiling constant divides the head dim by the 64-column box as it
    stands (80 / 64 would drop columns 64-79): every ``NB`` of the flash
    forward, the flash backward and the paged body is
    ``hopper::box_cols<D>() / BOX``, whose static_assert fails the build
    at a head dim no body is laid out for and lays 80 out as 128; the
    paged CUDA-core body's ``EPL`` is asserted whole; each C entry
    dispatches D 80, and the wrappers take it."""
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    body = hopper[hopper.index("constexpr int box_cols()"):]
    body = body[:body.index("\n}\n")]
    assert "static_assert(D == 64 || D == 80 || D == 128 || D == 192 || D == 256" in body
    assert "return D == 80 ? 128 : D == 192 ? 256 : D;" in body
    assert "split3_kernel<80>" in hopper
    for name in ("flash_attention", "flash_attention_bwd", "paged_attention"):
        text = re.sub(r"//[^\n]*", "", (_build.CSRC / f"{name}.cu").read_text())  # the code
        assert not re.search(r"\bD\s*/\s*BOX\b", text), name
        nb = re.findall(r"\bNB = ([^,;]+)[,;]", text)
        assert nb and all(x.strip() in ("hopper::box_cols<D>() / BOX", "L::NB")
                          for x in nb), (name, nb)
        assert re.search(r"if \(D == 80\)|D == 80\s+\?", text), name
    paged = (_build.CSRC / "paged_attention.cu").read_text()
    epl = re.findall(r"constexpr int EPL = ([^;]+);", paged)
    assert epl == ["D % 32 == 0 ? D / 32 : 4"]
    assert re.search(r"LANES \* EPL == D &&\s+LANES <= 32", paged)
    assert re.search(r"wgmma_shape\(int D, int P, int rep\) \{\s*return \(D == 64 \|\| D == 80",
                     paged)
    fwd = (_build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"struct Tiles<80, 1>", fwd) and re.search(r"struct Tiles<80, 3>", fwd)
    bwd = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert re.search(r"struct Shape<80, 1>", bwd) and re.search(r"struct Shape<80, 3>", bwd)
    assert 80 in tflash.HEAD_DIMS and 80 in tpaged_kernel.HEAD_DIMS
    assert tpaged_kernel.wgmma_body(torch.bfloat16, D, 16, 1)
    assert not tpaged_kernel.wgmma_body(torch.float32, D, 16, 1)


def test_chip_gate_holds_d80_in_every_attention_kernel():
    """chip_smoke.py's gate reads head dim 80 in the flash forward (causal
    and not, S 1, S ragged against the 128-key tiles, zamba2's MHA train
    shape), the flash backward (the same) and the paged decode (rep 1 at
    zamba2's serve shape, the wgmma body's page sizes, and the CUDA-core
    body's), and plants a fault only head dim 80 can show: the flash
    backward's input maps at an inner extent of whole boxes, 128, so that
    a box reads the next head's columns into Delta = rowsum(dO O) (the
    forward reads no column past 80 into a score and stores none, so the
    same fault is inert there)."""
    cs = _chip_smoke()
    fwd = [c for c in cs.FLASH_CASES if c[4] == D]
    bwd = [c for c in cs.FLASH_BWD_CASES if c[4] == D]
    paged = [c for c in cs.PAGED_CASES if c[3] == D]
    for cases in (fwd, bwd):
        assert {c[5] for c in cases} == {True, False}
        assert 1 in {c[1] for c in cases}
        assert any(c[1] % 128 and c[1] > 128 for c in cases)
        assert cs.ZAMBA2_TRAIN_ATTN in [c[:6] for c in cases]
    assert cs.ZAMBA2_TRAIN_ATTN == (1, 4096, 32, 32, 80, True)
    assert {c[1] // c[2] for c in paged} >= {1, 2} and {c[4] for c in paged} >= {8, 16, 64}
    assert any(c[:5] == (8, 32, 32, 80, 16) for c in paged)
    (fault,) = [f for f in cs.FAULTS if "inner extent" in f[2]]
    name, kernels, _, old, new, dname = fault
    assert (name, kernels, dname) == ("flash_attention_bwd", ("flash_attention_bwd",),
                                      "bfloat16")
    assert old == "constexpr int MAP_COLS = D;  // the inner extent of the q, k, v, o and dO maps"
    assert "DqSmem<D, NP>::NB * BOX" in new

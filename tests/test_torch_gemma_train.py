"""The port's gemma3 training slice against the JAX package on the CPU:
the plain flash attention's vjp with a sliding window (causal, GQA, head
dim 256, ragged S) against the vjp of the JAX ``kops.flash_attention``
and of its oracle; the reduced gemma3's next-token loss and every
gradient leaf against ``jax.value_and_grad`` of the JAX ``loss_for``
(its Pallas flash and xent in interpret mode, and its jnp attention), at
microbatch 1 and 2; a 20-step loss trajectory against the JAX
``make_train_step``; and the train CLI with ``--arch gemma3-4b
--reduced``: its first loss against JAX on that batch with the JAX
launcher's rolled labels, and a run killed after a checkpoint and
resumed, which repeats the uninterrupted losses bit for bit.  Inputs come
from numpy seeds and go to both packages."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.accum import accumulate_grads
from repro_torch.data import DataPipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as cli
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import flatten_tree, tree_map_paths
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts

from test_torch_gemma import W, gemma_cfgs, gemma_params
from test_torch_train import TRAJ_REL

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 128                     # S a multiple of 128: the JAX Pallas flash runs
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)   # the JAX flash tests' f32 bar
LOSS_REL = 1e-5                   # f32; the two frameworks sum in other orders
LEAF_REL, LEAF_FLOOR = 1e-5, 1e-8  # |g - g_jax| <= 1e-5 max|g_jax| + 1e-8, per leaf
FAULT_EXIT_CODE = 117             # repro_torch.train.faults.FAULT_EXIT_CODE


# ---------------------------------------------------------------------------
# the flash backward with a window, plain version against JAX
# ---------------------------------------------------------------------------


def _flash_inputs(seed, Bb, S_, H, Hkv, D):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((Bb, S_, H, D), (Bb, S_, Hkv, D), (Bb, S_, Hkv, D), (Bb, S_, H, D)))


@pytest.mark.parametrize("S_,window,oracle", [(256, 64, False), (128, 200, False),
                                               (200, 64, True), (77, 30, True)])
def test_windowed_flash_grad_matches_jax(S_, window, oracle):
    """dq, dk, dv of the plain version with a causal sliding window, GQA
    8 / 4 and head dim 256, against the vjp of the JAX
    ``kops.flash_attention`` (its Pallas forward in interpret mode) or,
    at ragged S, which that forward refuses, of its oracle."""
    q, k, v, w = _flash_inputs(S_ + window, 1, S_, 8, 4, 256)
    scale = 256.0**-0.5
    if oracle:
        fn = lambda q_, k_, v_: jref.flash_attention_ref(q_, k_, v_, causal=True, window=window,
                                                         scale=scale)
    else:
        fn = lambda q_, k_, v_: jops.flash_attention(q_, k_, v_, True, window, 0.0, scale)
    want = jax.grad(lambda *a: (fn(*a) * w).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    ops.reset_launch_counts()
    (ops.flash_attention(tq, tk, tv, True, window, 0.0, scale)
     * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), err_msg=name,
                                   **FLASH_TOL)
    assert not ops.launch_counts


# ---------------------------------------------------------------------------
# reduced gemma3 (local window 16, global) against JAX
# ---------------------------------------------------------------------------

def _runs(jcfg, tcfg, use_pallas=False, **kw):
    kw = dict(sharding="ddp", param_dtype="float32", activation_dtype="float32", **kw)
    return (JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, "train"),
                       use_pallas=use_pallas, **kw),
            RunConfig(model=tcfg, shape=ShapeConfig("t", S, B, "train"), **kw))


def _batch(seed, vocab):
    """Next-token labels as the JAX launcher builds them for a decoder:
    tokens rolled by one and the loss mask the attention mask, here with a
    partial last row."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(4, vocab, (B, S)).astype(np.int32)
    attn = np.ones((B, S), np.float32)
    attn[-1, S - 37:] = 0.0
    toks[-1, S - 37:] = 0
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1), "loss_mask": attn}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = gemma_cfgs(64)
    jmodel, params = gemma_params(jcfg, seed=1)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_jax_params(params)
    return jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel


def _leaf_err(got, want):
    """Largest error over the leaf's limit (passes at <= 1)."""
    return float(np.abs(got - want).max()) / (LEAF_REL * float(np.abs(want).max()) + LEAF_FLOOR)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_loss_and_every_grad_leaf_match_jax(models, microbatch, use_pallas):
    """The next-token loss, its metrics and every gradient leaf (the
    windowed and the global attention's backward reached through two
    rematerialised layers with qk-norm and post-norms, and the chunked
    loss) against ``jax.value_and_grad`` of the JAX ``loss_for``,
    accumulated over the microbatches; JAX with its Pallas flash and xent
    in interpret mode (``use_pallas``) or its jnp attention."""
    jcfg, jmodel, params, tmodel = models
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
    assert {"groups.0.0.mixer.q_norm", "groups.0.1.post2.scale"} <= set(jflat)
    worst = {k: _leaf_err(tgrads[k].numpy(), w) for k, w in jflat.items()}
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_20_step_trajectory_matches_jax(models):
    """Both packages' train steps (remat, chunked next-token loss, AdamW)
    on the same 20 batches, JAX with its jnp attention (its Pallas flash
    is held to it above); the loss falls and follows JAX at TRAJ_REL."""
    jcfg, jmodel, params, tmodel = models
    jrun, trun = _runs(jcfg, tmodel.cfg)
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=20, weight_decay=0.1)
    jstep = jax.jit(jts.make_train_step(jmodel, jrun, joptim.AdamWConfig(**opt)))
    tstep = tts.make_train_step(tmodel, trun, toptim.AdamWConfig(**opt))
    jstate = {"params": params, "opt": joptim.init_opt_state(params)}
    tstate = tts.init_state(tmodel, trun, seed=None)
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
# the train CLI
# ---------------------------------------------------------------------------

CLI_ARGS = ["--device", "cpu", "--reduced", "--arch", "gemma3-4b", "--batch", "4",
            "--seq", "48", "--n-functions", "150", "--workers", "2", "--log-every", "1"]


def _env(**extra):
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), **extra}


def _run(args, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, env=env or _env(),
                          timeout=timeout)


def _step_lines(stdout):
    """{step: 'loss=... xent=... acc=...'} of the per-step lines."""
    out = {}
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) > 4 and parts[0] == "step":
            out[int(parts[1])] = " ".join(parts[2:5])
    return out


@pytest.fixture
def one_thread():
    """``cli.main`` sets one intra-op thread, as a bit-exact run needs;
    the worker's setting comes back afterwards."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def test_cli_first_loss_is_the_jax_loss_on_its_batch(tmp_path, one_thread):
    """``main`` trains the reduced gemma3-4b (two local layers of window
    16, at S 48 past it) from its seed-0 parameters; its first loss
    equals the JAX ``loss_for`` of those parameters on the pipeline's
    first batch with the JAX launcher's labels: the tokens rolled by one
    and the attention mask as the loss mask."""
    data = str(tmp_path / "data")
    _, log = cli.main(CLI_ARGS + ["--steps", "2", "--data-dir", data])
    cfg = dataclasses.replace(reduced(get_config("gemma3-4b")), max_position=4096)
    assert {s.window for g in cfg.schedule for s in g.pattern} == {W}
    pipe = DataPipeline.build(data, n_functions=150, seq_len=48, batch_size=4,
                              vocab_size=cfg.vocab_size, work_fn=cli.make_work_fn(cfg))
    try:
        first = pipe.peek_batch(0)
    finally:
        pipe.close()
    toks, attn = first["tokens"].numpy(), first["loss_mask"].numpy()
    labels = np.roll(toks, -1, axis=1)
    assert np.array_equal(first["labels"].numpy(), labels)
    model = Model(cfg, seed=0, device="cpu")
    jparams = tree_map_paths(lambda path, _: jnp.asarray(model.state_dict()[path].numpy()),
                             model.specs())
    jcfg = dataclasses.replace(jreduced(jget_config("gemma3-4b")), max_position=4096)
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("cli", 48, 4, "train"), sharding="ddp",
                      param_dtype="float32", activation_dtype="float32")
    jloss, _ = jts.loss_for(jbuild_model(jcfg), jparams,
                            {"tokens": jnp.asarray(toks, jnp.int32),
                             "labels": jnp.asarray(labels, jnp.int32),
                             "loss_mask": jnp.asarray(attn)}, run=jrun)
    np.testing.assert_allclose(log.metrics[0]["loss"], float(jloss), rtol=LOSS_REL)


def test_cli_killed_and_resumed_repeats_the_losses(tmp_path):
    """Killed by the fault point after its step-3 checkpoint's shard (step
    6's manifest never written), then ``--resume``-d: steps 4-8 repeat
    the uninterrupted run's losses bit for bit."""
    base = CLI_ARGS + ["--steps", "8", "--data-dir", str(tmp_path / "data")]
    full = _run(base)
    assert full.returncode == 0 and "[done]" in full.stdout, full.stderr[-3000:]
    assert "[train] gemma3-4b-smoke" in full.stdout
    ck = str(tmp_path / "ck")
    fault = {"REPRO_FAULT_PHASE": "ckpt_commit", "REPRO_FAULT_STEP": "6",
             "REPRO_FAULT_LOG": str(tmp_path / "kill.log")}
    killed = _run(base + ["--ckpt-dir", ck, "--ckpt-every", "3"], env=_env(**fault))
    assert killed.returncode == FAULT_EXIT_CODE, killed.stderr[-3000:]
    assert ckpt.latest_step(ck) == 3
    resumed = _run(base + ["--ckpt-dir", ck, "--ckpt-every", "3", "--resume"], env=_env(**fault))
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "[resume] host 0 restored shard at step 3" in resumed.stdout
    want, got = _step_lines(full.stdout), _step_lines(resumed.stdout)
    assert sorted(want) == list(range(1, 9)) and sorted(got) == list(range(4, 9))
    assert {s: want[s] for s in got} == got
    assert ckpt.latest_step(ck) == 8

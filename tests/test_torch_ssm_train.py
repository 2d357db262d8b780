"""The port's mamba2 training slice against the JAX package on the CPU:
the plain versions of the ``ssd_scan`` backward kernel's passes against
the autograd of ``ssd_ref``; reduced mamba2-130m's next-token loss and
every gradient leaf against ``jax.value_and_grad`` of the JAX
``loss_for`` (its Pallas scan and xent in interpret mode, and its jnp
``ssd_chunked``), at microbatch 1 and 2; a 20-step loss trajectory
against the JAX ``make_train_step``; and the train CLI with ``--arch
mamba2-130m``: its first loss against JAX on that batch with the JAX
launcher's rolled labels (ROADMAP C13), and a run killed after a
checkpoint and resumed, which repeats the uninterrupted losses bit for
bit.  Inputs come from numpy seeds and go to both packages."""
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
from repro.configs.base import MAMBA as JMAMBA
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import uniform_schedule as juniform
from repro.core.accum import accumulate_grads as jaccumulate
from repro.models import build_model as jbuild_model
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MAMBA, LayerSpec, RunConfig, ShapeConfig, uniform_schedule
from repro_torch.core.accum import accumulate_grads
from repro_torch.data import DataPipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as cli
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import flatten_tree, tree_map_paths
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts

from test_torch_train import TRAJ_REL

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 70                      # 70 steps: two full chunks of 32 and a ragged one
PASS_REL = 1e-5                   # plain passes vs autograd, of each gradient's max
LOSS_REL = 1e-5                   # f32; the two frameworks sum in other orders
LEAF_REL, LEAF_FLOOR = 1e-5, 1e-8  # |g - g_jax| <= 1e-5 max|g_jax| + 1e-8, per leaf
FAULT_EXIT_CODE = 117             # repro_torch.train.faults.FAULT_EXIT_CODE


# ---------------------------------------------------------------------------
# the backward kernel's passes in plain code
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, Bb, S_, H, P, G, N):
    """The JAX kernel tests' distributions, drawn with numpy."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((Bb, S_, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S_, H))))      # softplus
    A = -np.exp(rng.standard_normal(H) * 0.5)
    Bm = rng.standard_normal((Bb, S_, G, N))
    Cm = rng.standard_normal((Bb, S_, G, N))
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, dt, A, Bm, Cm)]


# (B, S, H, P, G, N, chunk): S a multiple of the chunk, ragged, shorter
# than the chunk; G = 1 and G > 1
PASS_CASES = [(2, 96, 4, 16, 1, 8, 32), (2, 100, 4, 16, 2, 8, 32),
              (1, 20, 6, 16, 3, 16, 32), (2, 70, 6, 8, 1, 16, 64)]


@pytest.mark.parametrize("gstate", ["zero", "nonzero"])
@pytest.mark.parametrize("Bb,S_,H,P,G,N,chunk", PASS_CASES)
def test_plain_backward_passes_compose_to_the_autograd_of_ssd_ref(Bb, S_, H, P, G, N, chunk,
                                                                   gstate):
    """``ref.ssd_bwd_ref`` (the chunk states, the output side of the first
    pass, the reverse carry, the per-chunk gradients, the head sums)
    against ``torch.autograd.grad`` of ``ssd_ref`` for (gy, gstate), each
    gradient within 1e-5 of its largest magnitude.  Train mode feeds a
    zero gstate."""
    inp = _ssd_inputs(S_ + G, Bb, S_, H, P, G, N)
    rng = np.random.RandomState(S_)
    gy = torch.from_numpy(rng.standard_normal((Bb, S_, H, P)).astype(np.float32))
    gs = torch.from_numpy(rng.standard_normal((Bb, H, N, P)).astype(np.float32))
    if gstate == "zero":
        gs = torch.zeros_like(gs)
    xs = [t.clone().requires_grad_(True) for t in inp]
    want = torch.autograd.grad(ref.ssd_ref(*xs, chunk), xs, (gy, gs))
    got = ref.ssd_bwd_ref(*inp, gy, gs, chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        err = (g - w).abs().max().item()
        assert err <= PASS_REL * w.abs().max().item(), (name, err)


def test_plain_passes_hand_on_the_states_and_their_gradients():
    """The reverse carry's dS_out of each chunk is the gradient of that
    chunk's outgoing state (the final state of a prefix of the steps) in
    the plain scan, and the chunk states are the forward carry's."""
    Bb, S_, H, P, G, N, chunk = 1, 96, 2, 8, 1, 8, 32
    x, dt, A, Bm, Cm = _ssd_inputs(3, Bb, S_, H, P, G, N)
    gy = torch.from_numpy(np.random.RandomState(4).standard_normal((Bb, S_, H, P))
                          .astype(np.float32))
    U, decay = ref.ssd_chunk_states(x, dt, A, Bm, chunk)
    V = ref.ssd_chunk_state_grads(dt, A, Cm, gy, chunk)
    dstates = ref.ssd_carry_grads(V, decay, torch.zeros(Bb, H, N, P))
    for c in range(3):
        # y of the later steps, as a function of the state leaving chunk c
        s0 = torch.zeros(Bb, H, N, P, requires_grad=True)
        tail = [t[:, (c + 1) * chunk:] if t.dim() > 1 else t for t in (x, dt, A, Bm, Cm)]
        if tail[0].shape[1]:
            y, _ = ref.ssd_ref(*tail, chunk, initial_state=s0)
            (want,) = torch.autograd.grad(y, s0, gy[:, (c + 1) * chunk:])
        else:
            want = torch.zeros_like(s0)
        torch.testing.assert_close(dstates[:, c], want, atol=1e-5, rtol=1e-5)
    states_in, final = ref.ssd_carry(U, decay)
    torch.testing.assert_close(final, ref.ssd_ref(x, dt, A, Bm, Cm, chunk)[1], atol=1e-5,
                               rtol=1e-5)


def test_ssd_backward_on_a_cuda_tensor_needs_the_kernel():
    """No plain fallback on the card: the wrapper takes CUDA tensors only,
    and the backward of ``ops.ssd`` on CPU tensors launches nothing."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    inp = _ssd_inputs(0, 1, 40, 2, 16, 1, 8)
    gy, gs = torch.zeros(1, 40, 2, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ssd_scan_bwd(*inp, gy, gs, 32)
    ops.reset_launch_counts()
    xs = [t.requires_grad_(True) for t in inp]
    y, st = ops.ssd(*xs, 32)
    (y.sum() + st.sum()).backward()
    assert not ops.launch_counts and all(t.grad is not None for t in xs)


# ---------------------------------------------------------------------------
# reduced mamba2-130m against JAX
# ---------------------------------------------------------------------------

def _cfgs(n_layers=2):
    jcfg = dataclasses.replace(jreduced(jget_config("mamba2-130m")),
                               schedule=juniform(n_layers, JLayerSpec(kind=JMAMBA, has_mlp=False)))
    tcfg = dataclasses.replace(reduced(get_config("mamba2-130m")),
                               schedule=uniform_schedule(n_layers, LayerSpec(kind=MAMBA,
                                                                             has_mlp=False)))
    return jcfg, tcfg


def _runs(jcfg, tcfg, use_pallas=False, **kw):
    kw = dict(sharding="ddp", param_dtype="float32", activation_dtype="float32", **kw)
    return (JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, "train"),
                       use_pallas=use_pallas, **kw),
            RunConfig(model=tcfg, shape=ShapeConfig("t", S, B, "train"), **kw))


def _batch(seed, vocab):
    """Next-token labels as the JAX launcher builds them for a decoder:
    tokens rolled by one (the last position predicts the row's first
    token, ROADMAP C13) and the loss mask the attention mask, here with a
    partial last row."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(4, vocab, (B, S)).astype(np.int32)
    attn = np.ones((B, S), np.float32)
    attn[-1, S - 17:] = 0.0
    toks[-1, S - 17:] = 0
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1), "loss_mask": attn}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.fixture(scope="module")
def models():
    """One JAX-initialised parameter set in both packages; the leaves JAX
    inits to constants (D, gate_norm, norm scales) are re-drawn so every
    leaf carries information."""
    jcfg, tcfg = _cfgs()
    jmodel = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(np.array, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    for path, a in flatten_tree(params).items():
        if path.rsplit(".", 1)[-1] in ("D", "gate_norm", "scale"):
            a[...] = 1.0 + 0.3 * rng.standard_normal(a.shape)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_jax_params(params)
    return jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel


def _leaf_err(got, want):
    """Largest error over the leaf's limit (passes at <= 1)."""
    return float(np.abs(got - want).max()) / (LEAF_REL * float(np.abs(want).max()) + LEAF_FLOOR)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_loss_and_every_grad_leaf_match_jax(models, microbatch, use_pallas):
    """The next-token loss, its metrics and every gradient leaf (the SSD
    backward reached through two rematerialised layers and the chunked
    loss) against ``jax.value_and_grad`` of the JAX ``loss_for``,
    accumulated over the microbatches; JAX with its Pallas ``ssd`` and
    ``xent`` in interpret mode (``use_pallas``) or its jnp scan."""
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
    assert any(".mixer.A_log" in k for k in jflat)      # the scan's own leaves
    worst = {k: _leaf_err(tgrads[k].numpy(), w) for k, w in jflat.items()}
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_20_step_trajectory_matches_jax(models):
    """Both packages' train steps (remat, chunked next-token loss, AdamW)
    on the same 20 batches, JAX with its jnp scan (its Pallas scan is held
    to it above); the loss falls and follows JAX at TRAJ_REL."""
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

CLI_ARGS = ["--device", "cpu", "--reduced", "--arch", "mamba2-130m", "--batch", "4",
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
    """``main`` trains reduced mamba2-130m from its seed-0 parameters; its
    first loss equals the JAX ``loss_for`` of those parameters on the
    pipeline's first batch with the JAX launcher's labels: the tokens
    rolled by one and the attention mask as the loss mask."""
    data = str(tmp_path / "data")
    _, log = cli.main(CLI_ARGS + ["--steps", "2", "--data-dir", data])
    cfg = dataclasses.replace(reduced(get_config("mamba2-130m")), max_position=48)
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
    jcfg = dataclasses.replace(jreduced(jget_config("mamba2-130m")), max_position=48)
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
    assert "[train] mamba2-130m-smoke" in full.stdout
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

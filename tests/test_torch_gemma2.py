"""The port's gemma2-27b slice against the JAX package on the CPU, in f32:
the config field for field; the parameters carried over from JAX; the
attention logit softcap (50) with gemma2's query scale (144^-0.5) and the
final logit softcap (30) in the train forward, the prefill and a decode
past three windows (JAX with its Pallas kernels in interpret mode, and
with its jnp oracles); the paged engine's tokens and logits; the
next-token loss and every gradient leaf at microbatch 1 and 2; a 20-step
trajectory; and the softcap backward, as the plain version's autograd
against ``jax.vjp`` of the JAX oracle and of its Pallas path, and as the
CPU emulation of the CUDA kernel's arithmetic (``ref.flash_bwd_softcap_
emulated``) against the function in f64.

The test model is a reduced gemma2-27b: ``configs.base.reduced`` keeps
its (local, global) pattern, here with the window cut from 4096 to 16 so
that the prompts and batches run past it; the softcaps and the query
scale stay gemma2's.  One case runs at head dim 128 (gemma2's own), one
at 64.  Inputs come from numpy seeds and go to both packages."""
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
from repro.configs.base import ScheduleGroup as JScheduleGroup
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.accum import accumulate_grads as jaccumulate
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import paged_cache as jpaged
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch.configs import default_run_config, get_config, list_archs, reduced
from repro_torch.configs.base import LayerSpec, ScheduleGroup, ShapeConfig
from repro_torch.core.accum import accumulate_grads
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.models.params import flatten_tree
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve.engine import PagedServeEngine
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts

from test_torch_gemma import gemma_params
from test_torch_gemma_train import _batch, _jbatch, _leaf_err, _runs, _tbatch
from test_torch_train import TRAJ_REL

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-5)          # f32 on both sides, summed in other orders
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)    # the JAX flash tests' f32 bar
F32_TOL = 2e-5                            # chip_smoke.py's f32 flash backward bar (vs f64)
LOSS_REL = 1e-5
W = 16                                    # the reduced local layer's window
CAP, SCALE = 50.0, 144.0**-0.5            # gemma2's attention softcap and query scale


def gemma2_cfgs(head_dim: int):
    """(JAX, port) configs of the reduced gemma2-27b, its (local, global)
    pattern with the window cut to W, at ``head_dim``."""
    jcfg = dataclasses.replace(
        jreduced(jget_config("gemma2-27b")), head_dim=head_dim,
        schedule=(JScheduleGroup(pattern=(JLayerSpec(window=W), JLayerSpec()), repeats=1),))
    tcfg = dataclasses.replace(
        reduced(get_config("gemma2-27b")), head_dim=head_dim,
        schedule=(ScheduleGroup(pattern=(LayerSpec(window=W), LayerSpec()), repeats=1),))
    return jcfg, tcfg


_MODELS = {}


def models(head_dim: int):
    """One parameter set in both packages (JAX-initialised, the norm
    scales re-drawn around 1), built once per head dim."""
    if head_dim not in _MODELS:
        jcfg, tcfg = gemma2_cfgs(head_dim)
        jmodel, params = gemma_params(jcfg, seed=2)
        tmodel = build_model(tcfg, device="cpu")
        tmodel.load_jax_params(params)
        _MODELS[head_dim] = (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                             tmodel)
    return _MODELS[head_dim]


def _tokens(jcfg, S, seed):
    return np.random.RandomState(seed).randint(4, jcfg.vocab_size, (1, S)).astype(np.int32)


def _leaves(tree):
    return {f"{pi}.{name}": leaf for pi, layer in enumerate(tree["groups"][0])
            for name, leaf in layer["mixer"].items()}


# ---------------------------------------------------------------------------
# the config and the parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_matches_jax_field_for_field(size):
    """gemma2-27b in the port's registry equals the JAX package's config in
    every field (the schedule's layer specs included), at full size and
    reduced; its full size is gemma2's: 46 layers alternating a window of
    4096 and global, 27.2 G parameters."""
    assert "gemma2-27b" in list_archs()
    tcfg, jcfg = get_config("gemma2-27b"), jget_config("gemma2-27b")
    if size == "reduced":
        tcfg, jcfg = reduced(tcfg), jreduced(jcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if size == "full":
        assert tcfg.n_layers == 46 and tcfg.n_heads == 32 and tcfg.n_kv_heads == 16
        assert [s.window for s in tcfg.schedule[0].pattern] == [4096, None]
        assert (tcfg.attn_logit_softcap, tcfg.final_logit_softcap) == (50.0, 30.0)
        n = sum(int(np.prod(s.shape)) for s in flatten_tree(
            transformer.model_specs(tcfg)).values())
        assert abs(n - 27.2e9) < 0.05e9


@pytest.mark.parametrize("head_dim", [64, 128])
def test_from_jax_params_round_trips(head_dim):
    jcfg, _, params, tmodel = models(head_dim)
    flat = flatten_tree(jax.tree_util.tree_map(np.array, params))
    sd = tmodel.state_dict()
    assert sorted(sd) == sorted(flat)
    assert {"groups.0.0.post1.scale", "groups.0.1.post2.scale"} <= set(sd)
    assert sd["groups.0.0.mixer.wq"].shape == (1, jcfg.d_model, jcfg.n_heads, head_dim)
    for k, a in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)


# ---------------------------------------------------------------------------
# the softcaps in the forward, the prefill, decode and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [64, 128])
def test_train_forward_with_both_softcaps_matches_jax(head_dim):
    """The whole model in train mode at S past the window: the attention
    softcap and query scale in both layers, the post-norms, and the final
    logit softcap (every logit inside (-30, 30))."""
    jcfg, jmodel, params, tmodel = models(head_dim)
    toks = _tokens(jcfg, 45, 3)
    want, _, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.no_grad():
        got, _, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()}, mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.abs().max() <= 30.0


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("S,L,use_pallas", [(40, 37, False), (128, 101, True)])
def test_prefill_matches_jax(head_dim, S, L, use_pallas):
    """A prompt of L tokens right-padded to S: hidden state and both
    layers' caches (the local layer's ring); at S = 128 the JAX side runs
    its Pallas flash kernel in interpret mode, with the softcap in both
    layers and the window in the local one."""
    jcfg, jmodel, params, tmodel = models(head_dim)
    toks = np.zeros((1, S), np.int32)
    toks[0, :L] = _tokens(jcfg, L, S)[0]
    jh, jcache, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                 return_hidden=True, use_pallas=use_pallas,
                                 paged={"length": jnp.int32(L)})
    with torch.inference_mode():
        th, tcache, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()},
                                     mode="prefill", return_hidden=True, paged={"length": L})
    np.testing.assert_allclose(th[:, :L].numpy(), np.asarray(jh)[:, :L], **TOL)
    for name, leaf in _leaves(jcache).items():
        got = _leaves(tcache)[name].numpy()
        assert got.shape == leaf.shape, name
        np.testing.assert_allclose(got, np.asarray(leaf), err_msg=name, **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_past_three_windows_matches_jax(use_pallas):
    """One slot prefilled with 8 tokens, then decoded through the paged
    step to position 55 (past 3 W): every tick's logits (the global layer
    through the paged kernel's softcap, the local one over its ring)
    against JAX's decode step, jitted (its paged kernel in interpret mode,
    or its jnp oracle), and the last against the port's own full forward."""
    jcfg, jmodel, params, tmodel = models(128)
    page, n_pages, S0, total = 8, 12, 8, 56
    toks = _tokens(jcfg, total, 11)
    tables = np.zeros((2, 8), np.int32)
    tables[0, :7] = (3, 8, 1, 10, 5, 2, 7)
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
    ring = _leaves(tpools)["0.pos"][0, 0]
    assert sorted(ring.tolist()) == list(range(total - W, total))
    with torch.no_grad():
        full, _, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()}, mode="train")
    np.testing.assert_allclose(tlogits[0, 0].numpy(), full[0, -1].numpy(), **TOL)


LENS = (70, 13, 100, 5)        # shorter and longer than W; 70 and 100 at bucket 128
MAX_NEW = 12                   # the 13- and 5-token prompts' rings wrap in decode
ENGINE_KW = dict(page=8, n_pages=64, max_slots=3)


def _drive(eng, step, jcfg):
    """Greedy tokens and every prefill's and decode tick's logits: two
    requests, then two more after two ticks; 3 slots, so the last waits."""
    log = []

    def recording(fn, key):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            logits = np.asarray(out[0], dtype=np.float32)
            if key == "decode":
                logits = logits[sorted(eng._active), 0]
            log.append((key, logits.reshape(-1, logits.shape[-1])[-1:]
                        if key == "prefill" else logits))
            return out
        return wrapped

    eng._prefill = recording(eng._prefill, "prefill")
    eng._decode = recording(eng._decode, "decode")
    prompts = [_tokens(jcfg, n, i + 1)[0].tolist() for i, n in enumerate(LENS)]
    rids, finished = [eng.submit(p, MAX_NEW) for p in prompts[:2]], {}
    for tick in range(200):
        if tick == 2:
            rids += [eng.submit(p, MAX_NEW) for p in prompts[2:]]
        for req in step():
            finished[req.rid] = req.out
        if len(finished) == len(prompts):
            break
    return [finished[r] for r in rids], log


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_matches_jax_tokens_and_logits(use_pallas):
    """The paged engines of both packages on the same staggered requests:
    the same greedy tokens, and every prefill's and decode tick's logits
    (final softcap 30 included) within TOL; JAX with its Pallas flash and
    paged kernels in interpret mode, or its jnp oracles."""
    jcfg, jmodel, params, tmodel = models(128)
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
# the softcap backward: the plain version against JAX, the kernel's arithmetic
# ---------------------------------------------------------------------------


def _flash_inputs(seed, Bb, S_, H, Hkv, D, amp=1.0):
    """q (times ``amp``, so that the scores reach the cap), k, v and an
    output gradient, f32."""
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.standard_normal(s).astype(np.float32)
                  for s in ((Bb, S_, H, D), (Bb, S_, Hkv, D), (Bb, S_, Hkv, D), (Bb, S_, H, D)))
    return (q * np.float32(amp)).astype(np.float32), k, v, w


@pytest.mark.parametrize("S_,D,window,cap,amp,oracle", [
    (256, 64, 64, CAP, 8.0, False), (128, 128, None, CAP, 1.0, False),
    (200, 128, 64, CAP, 8.0, True), (77, 64, None, 5.0, 4.0, True)])
def test_softcap_flash_grad_matches_jax(S_, D, window, cap, amp, oracle):
    """dq, dk, dv of the plain version with the logit softcap (causal, GQA
    4 / 2, gemma2's query scale), windowed and not, at head dim 64 and
    128, against the vjp of the JAX ``kops.flash_attention`` (its Pallas
    forward in interpret mode) or, at ragged S, which that forward
    refuses, of its oracle; q drawn times ``amp`` so that tanh bends."""
    q, k, v, w = _flash_inputs(S_ + D, 1, S_, 4, 2, D, amp)
    if oracle:
        fn = lambda q_, k_, v_: jref.flash_attention_ref(
            q_, k_, v_, causal=True, window=window, softcap=cap, scale=SCALE)
    else:
        fn = lambda q_, k_, v_: jops.flash_attention(q_, k_, v_, True, window, cap, SCALE)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    ops.reset_launch_counts()
    (ops.flash_attention(tq, tk, tv, True, window, cap, SCALE)
     * torch.from_numpy(w)).sum().backward()
    for name, got, r in zip("qkv", (tq, tk, tv), want):
        scale_ = max(1.0, float(np.abs(np.asarray(r)).max()))
        np.testing.assert_allclose(got.grad.numpy() / scale_, np.asarray(r) / scale_,
                                   err_msg=name, **FLASH_TOL)
    assert not ops.launch_counts


def _grads64(q, k, v, do, window, cap):
    """The gradients of the plain function in f64 (chip_smoke.py's f32
    gate reference)."""
    xs = [torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v)]
    o = ref.flash_attention_ref(*xs, causal=True, window=window, softcap=cap, scale=SCALE)
    return [g.numpy() for g in torch.autograd.grad(o, xs, torch.from_numpy(do).double())]


# reduced copies of chip_smoke.py's softcap backward cases (B, S, H, Hkv,
# window, cap, amp) at D 128: gemma2's cap at its scale, a window, the
# 32-row tiles' ragged edges, cap 5 with q times 4 and cap 1 with q times
# 4 (half the scores at |t| > 0.99: 1 - t^2 cancels)
SOFTCAP_CASES = [
    (1, 130, 4, 2, 40, CAP, 1.0),
    (2, 65, 4, 2, None, 5.0, 4.0),
    (1, 130, 4, 2, 50, 1.0, 4.0),
]


@pytest.mark.parametrize("case", SOFTCAP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_softcap_backward_emulation_holds_the_f32_bar(case):
    """The kernel's softcap arithmetic on three pieces (P from the lse, 1 -
    t^2 as one fma, dq's and dkdv's orders of the products, 32-key and
    32-row tiles of fresh partials) within 2e-5 of the function in f64,
    the card gate's reference, and of the JAX oracle's vjp, by a margin
    (under 1/2 of the bar: the card's accumulation order fits in the
    rest)."""
    B, S_, H, Hkv, window, cap, amp = case
    q, k, v, do = _flash_inputs(S_ + H, B, S_, H, Hkv, 128, amp)
    got = ref.flash_bwd_softcap_emulated(*map(torch.from_numpy, (q, k, v, do)), softcap=cap,
                                         window=window, scale=SCALE)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_ref(
        q_, k_, v_, causal=True, window=window, softcap=cap, scale=SCALE),
        *map(jnp.asarray, (q, k, v)))
    jax_grads = [np.asarray(x) for x in vjp(jnp.asarray(do))]
    for want, bar in ((_grads64(q, k, v, do, window, cap), F32_TOL / 2), (jax_grads, F32_TOL)):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = np.abs(g.numpy() - w).max()
            assert err <= bar, (name, err)


@pytest.mark.parametrize("case", SOFTCAP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_softcap_backward_without_the_derivative_misses_the_bar(case):
    """The same arithmetic without the factor 1 - t^2 (the planted fault
    of chip_smoke.py) misses 2e-5 on dq and dk, by far at cap 1 and 5;
    dv does not carry the factor."""
    B, S_, H, Hkv, window, cap, amp = case
    q, k, v, do = _flash_inputs(S_ + H, B, S_, H, Hkv, 128, amp)
    got = ref.flash_bwd_softcap_emulated(*map(torch.from_numpy, (q, k, v, do)), softcap=cap,
                                         window=window, scale=SCALE, derivative=False)
    want = _grads64(q, k, v, do, window, cap)
    errs = [np.abs(g.numpy() - w).max() for g, w in zip(got, want)]
    assert errs[0] > F32_TOL and errs[1] > F32_TOL and errs[2] <= F32_TOL / 2, errs
    if cap < CAP:
        assert min(errs[:2]) > 1e3 * F32_TOL, errs


def test_softcap_emulation_on_one_piece_misses_the_bar():
    """On plain bf16 operands (one piece) the same order misses 2e-5: the
    three pieces are what holds the f32 bar."""
    q, k, v, do = _flash_inputs(5, 1, 130, 4, 2, 128)
    got = ref.flash_bwd_softcap_emulated(*map(torch.from_numpy, (q, k, v, do)), softcap=CAP,
                                         window=40, scale=SCALE, pieces=1)
    for name, g, w in zip(("dq", "dk", "dv"), got, _grads64(q, k, v, do, 40, CAP)):
        assert np.abs(g.numpy() - w).max() > F32_TOL, name


# ---------------------------------------------------------------------------
# training: the loss, every gradient leaf, 20 steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_models():
    jcfg, tcfg = gemma2_cfgs(64)
    jmodel, params = gemma_params(jcfg, seed=1)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_jax_params(params)
    return jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_loss_and_every_grad_leaf_match_jax(train_models, microbatch, use_pallas):
    """The next-token loss (its logits through the final softcap), its
    metrics and every gradient leaf (both layers' softcapped attention
    backward, windowed and global, through rematerialised layers with
    post-norms) against ``jax.value_and_grad`` of the JAX ``loss_for``,
    accumulated over the microbatches; JAX with its Pallas flash and xent
    in interpret mode (``use_pallas``) or its jnp attention."""
    jcfg, jmodel, params, tmodel = train_models
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
    worst = {k: _leaf_err(tgrads[k].numpy(), w) for k, w in jflat.items()}
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_20_step_trajectory_matches_jax(train_models):
    """Both packages' train steps (remat, chunked next-token loss with the
    final softcap, AdamW) on the same 20 batches, JAX with its jnp
    attention; the loss falls and follows JAX at TRAJ_REL.  lr 1e-2: the
    JAX-initialised logits sit near the cap, where its derivative is small,
    and at gemma3's 1e-3 the loss stays level over 20 steps."""
    jcfg, jmodel, params, tmodel = train_models
    jrun, trun = _runs(jcfg, tmodel.cfg)
    opt = dict(lr=1e-2, warmup_steps=5, total_steps=20, weight_decay=0.1)
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

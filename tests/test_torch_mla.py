"""The port's deepseek-v2-lite-16b slice (DeepSeek's multi-head latent
attention, MLA, with a dense layer 0 and fine-grained experts) against
the JAX package on the CPU, in f32: the config field for field at full
size and reduced; the parameter count whole and active; the MLA leaves
carried over from JAX; ``apply_mla`` in train and prefill mode at S 64
(JAX's one block) and S 600 (JAX's q-chunked branch, 512 + a remainder
of 88), its latent cache; the plain flash version with v's head dim
other than q's and its autograd against JAX's einsum form; the reduced
model's logits, loss, ``aux_loss`` and every gradient leaf; a 10-step
trajectory; the paged engines' tokens, logits and latent pools; the
launchers on the reduced model.

The test model is the reduced config (``configs.base.reduced``: the dense
layer 0 and one MoE layer, MLA at kv_lora 64, nope 32, rope 16, v 32)
with fine-grained routing (16 experts, top 6, 2 shared), built in both
packages by ``dataclasses.replace``.  The norm scales and MLA's latent
norm ``kv_ln`` (ones at init) are re-drawn around 1.  Every comparison
that runs the router first asserts that both packages chose the same
experts for every token (``RouteTaps``).  Inputs come from numpy seeds
and go to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import scaling as jscaling
from repro.core.accum import accumulate_grads as jaccumulate
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import paged_cache as jpaged
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch.configs import default_run_config, get_config, list_archs, reduced
from repro_torch.configs.base import MLA, ShapeConfig
from repro_torch.core import scaling
from repro_torch.core.accum import accumulate_grads
from repro_torch.data import DataPipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as cli
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import flatten_tree, tree_map_paths
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve.engine import PagedServeEngine
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts

from test_torch_gemma2 import ENGINE_KW, MAX_NEW, _drive
from test_torch_gemma_train import _batch, _jbatch, _leaf_err, _runs, _tbatch, one_thread  # noqa: F401
from test_torch_moe import LOSS_REL, TOL, RouteTaps, _cache_leaves, _grad_errors, _tokens
from test_torch_train import TRAJ_REL

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

ARCH = "deepseek-v2-lite-16b"
# deepseek-v2-lite-16b, whole and active (the routed experts' top 6 of 64)
PARAMS = (15_706_484_224, 2_661_150_208)
ROUTING = dict(n_experts=16, top_k=6, n_shared=2)


def mla_cfgs():
    """(JAX, port) configs: the reduced model with fine-grained routing."""
    def cut(cfg, red):
        cfg = red(cfg)
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **ROUTING))

    return cut(jget_config(ARCH), jreduced), cut(get_config(ARCH), reduced)


def _redraw(params, seed):
    """Norm scales and MLA's ``kv_ln`` (ones at init) re-drawn around 1."""
    rng = np.random.RandomState(seed)
    for path, a in flatten_tree(params).items():
        if path.rsplit(".", 1)[-1] in ("scale", "kv_ln"):
            a[...] = 1.0 + 0.2 * rng.standard_normal(a.shape)
    return params


_MODELS = {}


def models():
    """One JAX-initialised parameter set in both packages, built once."""
    if not _MODELS:
        jcfg, tcfg = mla_cfgs()
        jmodel = jbuild_model(jcfg)
        params = _redraw(jax.tree_util.tree_map(np.array, jmodel.init(jax.random.PRNGKey(5))), 5)
        tmodel = build_model(tcfg, device="cpu")
        tmodel.load_jax_params(params)
        _MODELS["m"] = (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel)
    return _MODELS["m"]


@pytest.fixture
def taps(monkeypatch):
    return RouteTaps(monkeypatch)


# ---------------------------------------------------------------------------
# the config and the parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_matches_jax_field_for_field(size):
    """deepseek-v2-lite-16b is in the port's registry and equals the JAX
    config in every field, at full size and reduced: 27 MLA layers (a
    dense layer 0, 26 MoE), head_dim 0 (MLA has its own)."""
    assert ARCH in list_archs()
    tcfg, jcfg = get_config(ARCH), jget_config(ARCH)
    if size == "reduced":
        tcfg, jcfg = reduced(tcfg), jreduced(jcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.head_dim == 0
    specs = [s for g in tcfg.schedule for s in g.pattern for _ in range(g.repeats)]
    assert {s.kind for s in specs} == {MLA} and not specs[0].moe and all(s.moe for s in specs[1:])
    if size == "full":
        m = tcfg.mla
        assert len(specs) == 27
        assert (m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim) == \
            (512, 128, 64, 128)
        assert (tcfg.moe.n_experts, tcfg.moe.top_k, tcfg.moe.n_shared) == (64, 6, 2)


def test_param_count_total_and_active_match_jax():
    """15.71 G parameters whole, and JAX's active count (the routed
    experts' top 6 of 64), which the MFU reads; 6 N_active D."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    n, act = scaling.param_count(cfg), scaling.param_count(cfg, active_only=True)
    assert (n, act) == (jscaling.param_count(jcfg),
                        jscaling.param_count(jcfg, active_only=True)) == PARAMS
    assert round(n / 1e9, 2) == 15.71
    assert scaling.model_flops(cfg, 10) == 60.0 * act


def test_from_jax_params_round_trips_the_mla_leaves():
    """Every leaf, MLA's wq (L, d, H, 48), wdkv (L, d, r + rope), kv_ln,
    wuk, wuv and wo among them, loads bit for bit from the JAX tree; the
    dense layer 0 has an ``mlp``, the other layer a ``moe``."""
    jcfg, _, params, tmodel = models()
    flat = flatten_tree(jax.tree_util.tree_map(np.array, params))
    sd = tmodel.state_dict()
    assert sorted(sd) == sorted(flat)
    m, d, H = jcfg.mla, jcfg.d_model, jcfg.n_heads
    want = {"wq": (1, d, H, m.qk_nope_head_dim + m.qk_rope_head_dim),
            "wdkv": (1, d, m.kv_lora_rank + m.qk_rope_head_dim), "kv_ln": (1, m.kv_lora_rank),
            "wuk": (1, m.kv_lora_rank, H, m.qk_nope_head_dim),
            "wuv": (1, m.kv_lora_rank, H, m.v_head_dim), "wo": (1, H, m.v_head_dim, d)}
    for pi in (0, 1):
        for leaf, shape in want.items():
            assert tuple(sd[f"groups.0.{pi}.mixer.{leaf}"].shape) == shape, (pi, leaf)
    assert "groups.0.0.mlp.wi" in sd and "groups.0.1.moe.router" in sd
    assert not any(k.startswith("groups.0.0.moe") or k.startswith("groups.0.1.mlp") for k in sd)
    for k, a in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)


# ---------------------------------------------------------------------------
# MLA alone, and the flash function at v's own head dim
# ---------------------------------------------------------------------------


def _mla_layer(seed):
    """One MLA layer's leaves for JAX's specs, drawn by numpy at 1 /
    sqrt(fan-in) (a leaf's every axis but the last: as a layer of the
    stacked model gets it, where JAX's init divides a 3-D leaf by its
    first axis, C15) and ``kv_ln`` around 1."""
    jcfg, tcfg = mla_cfgs()
    rng = np.random.RandomState(seed)
    p = {}
    for k, spec in jattn.mla_specs(jcfg).items():
        if spec.init == "ones":
            p[k] = 1.0 + 0.2 * rng.standard_normal(spec.shape)
        else:
            p[k] = rng.standard_normal(spec.shape) * np.prod(spec.shape[:-1]) ** -0.5
        p[k] = p[k].astype(np.float32)
    assert sorted(p) == sorted(tattn.mla_specs(tcfg))
    return jcfg, tcfg, p


@pytest.mark.parametrize("S", [64, 600])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_apply_mla_matches_jax(S, mode):
    """``apply_mla`` in train and prefill mode: the port's flash path (q
    and k at 48, v at 32) against JAX's einsums, at S 64 (one block) and
    S 600 (JAX's q-chunked branch: a 512-row chunk and a remainder of
    88); in prefill the latent cache ``ckv`` (B, S, 64) and the rope key
    ``kr`` (B, S, 16) too."""
    jcfg, tcfg, p = _mla_layer(7)
    x = np.random.RandomState(S).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    spec = jcfg.schedule[0].pattern[0]
    assert S <= jattn.ATTN_CHUNK or S % jattn.ATTN_CHUNK == 88
    jout, jcache = jattn.apply_mla({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                   jcfg, spec, positions=jnp.arange(S)[None], mode=mode)
    with torch.no_grad():
        tout, tcache = tattn.apply_mla({k: torch.from_numpy(v) for k, v in p.items()},
                                       torch.from_numpy(x), tcfg, tcfg.schedule[0].pattern[0],
                                       positions=torch.arange(S, dtype=torch.int32)[None],
                                       mode=mode)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    if mode == "train":
        assert tcache is None and jcache is None
        return
    assert sorted(tcache) == sorted(jcache) == ["ckv", "kr"]
    for k in ("ckv", "kr"):
        assert tcache[k].shape == jcache[k].shape
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("S,window", [(77, None), (200, 50)])
def test_flash_ref_with_its_own_v_head_dim_matches_jax(S, window):
    """The plain flash version at MLA's shape (q and k 48 columns, v 32,
    causal, its scale 48^-0.5 given) and its autograd against JAX's
    einsum form of the same function: the output (B, S, H, 32) and dq,
    dk, dv under one cotangent."""
    rng = np.random.RandomState(S)
    H, D, Dv = 4, 48, 32
    q, k = (rng.standard_normal((2, S, H, D)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, S, H, Dv)).astype(np.float32)
    ct = rng.standard_normal((2, S, H, Dv)).astype(np.float32)
    scale = D ** -0.5

    def jfn(q_, k_, v_):
        s = jnp.einsum("bqhe,bkhe->bhqk", q_, k_) * scale
        i, j = jnp.arange(S)[:, None], jnp.arange(S)[None, :]
        ok = j <= i
        if window is not None:
            ok &= j > i - window
        w = jax.nn.softmax(jnp.where(ok, s, -2e38), axis=-1)
        o = jnp.einsum("bhqk,bkhe->bqhe", w, v_)
        return jnp.sum(o * ct), o

    (_, jo), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    to = ops.flash_attention(tq, tk, tv, causal=True, window=window, scale=scale)
    assert to.shape == (2, S, H, Dv)
    (to * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ref.flash_attention_ref(*(x.detach() for x in (tq, tk, tv)),
                                                       window=window, scale=scale).numpy(),
                               np.asarray(jo), **TOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        assert _leaf_err(got.numpy(), np.asarray(want)) <= 1.0, name


def test_flash_wrapper_builds_mla_causal_without_a_softcap():
    """At q/k 192 and v 128 the kernel wrapper takes the shape and then
    wants the card; it refuses, before it looks at the device, the modes
    the D-192 bodies are not built for: a non-causal backward and a
    softcap (the (D, Dv) pairs it refuses are tests/test_torch_build.py's)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = torch.zeros(1, 4, 2, 192), torch.zeros(1, 4, 2, 192), torch.zeros(1, 4, 2, 128)
    o, lse = torch.zeros(1, 4, 2, 128), torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fa.flash_attention_bwd(q, k, v, o, lse, o)
    with pytest.raises(NotImplementedError, match="causal only"):
        fa.flash_attention_bwd(q, k, v, o, lse, o, causal=False)
    with pytest.raises(NotImplementedError, match="softcap"):
        fa.flash_attention_fwd(q, k, v, softcap=30.0)
    with pytest.raises(NotImplementedError, match="softcap"):
        fa.flash_attention_bwd(q, k, v, o, lse, o, softcap=30.0)


# ---------------------------------------------------------------------------
# the model: logits, the engine, the loss and gradients, training
# ---------------------------------------------------------------------------


def test_train_logits_and_aux_match_jax(taps):
    """The whole reduced model in train mode: the same experts for every
    token of the MoE layer, the logits and the aux."""
    jcfg, jmodel, params, tmodel = models()
    toks = _tokens(jcfg, 45, 3)
    want, _, jaux = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.no_grad():
        got, _, aux = tmodel.apply({"tokens": torch.from_numpy(toks).long()}, mode="train")
    taps.assert_same()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=LOSS_REL)
    assert aux.item() > 0


@pytest.mark.parametrize("S,L", [(40, 40), (128, 101)])
def test_prefill_matches_jax(S, L, taps):
    """A prompt of L tokens right-padded to S: the experts, the hidden
    state and both layers' latent caches (ckv, kr) at the real
    positions."""
    jcfg, jmodel, params, tmodel = models()
    toks = np.zeros((1, S), np.int32)
    toks[0, :L] = _tokens(jcfg, L, S + L)[0]
    jh, jcache, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, return_hidden=True,
                                 mode="prefill", paged={"length": jnp.int32(L)})
    with torch.inference_mode():
        th, tcache, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()},
                                     return_hidden=True, mode="prefill", paged={"length": L})
    taps.assert_same()
    np.testing.assert_allclose(th[:, :L].numpy(), np.asarray(jh)[:, :L], **TOL)
    leaves = _cache_leaves(tcache)
    assert sorted(leaves) == sorted(_cache_leaves(jcache)) == ["0.ckv", "0.kr", "1.ckv", "1.kr"]
    for name, leaf in _cache_leaves(jcache).items():
        got = leaves[name].numpy()
        assert got.shape == leaf.shape, name
        np.testing.assert_allclose(got[:, :, :L], np.asarray(leaf)[:, :, :L], err_msg=name, **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_matches_jax_tokens_logits_and_pools(use_pallas, taps):
    """The paged engines of both packages on the same staggered requests
    (3 slots, the last request waiting): the latent pools (layers, pages,
    page, 64) and (.., 16) shaped as JAX's ``build_pools``, the same
    experts in every prefill and tick, the same greedy tokens, and every
    prefill's and tick's logits within TOL (JAX's MLA decode is its
    absorbed einsum form either way; ``use_pallas`` reaches its xent and
    flash kernels' flags only)."""
    jcfg, jmodel, params, tmodel = models()
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
    kw = dict(page=ENGINE_KW["page"], n_pages=ENGINE_KW["n_pages"],
              max_slots=ENGINE_KW["max_slots"])
    jp = _cache_leaves(jpaged.build_pools(jcfg, **kw))
    tp = _cache_leaves(tpaged.build_pools(tmodel.cfg, device="cpu", **kw))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    assert jp["1.ckv"].shape == (1, ENGINE_KW["n_pages"], ENGINE_KW["page"], 64)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_loss_aux_and_every_grad_leaf_match_jax(microbatch, use_pallas, taps):
    """The next-token loss on the launcher's rolled labels (the last row
    partly padding), its metrics with ``aux_loss`` and every gradient
    leaf (MLA's wq, wdkv, kv_ln, wuk, wuv and wo through the flash
    backward, the dense layer 0, the router and the experts, through
    rematerialised layers) against ``jax.value_and_grad`` of the JAX
    ``loss_for``, accumulated over the microbatches; the experts of each
    microbatch's forward first.  JAX with its Pallas xent in interpret
    mode (``use_pallas``) or its jnp one."""
    jcfg, jmodel, params, tmodel = models()
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
    for leaf in ("wq", "wdkv", "kv_ln", "wuk", "wuv", "wo"):
        assert tgrads[f"groups.0.0.mixer.{leaf}"].abs().max() > 0, leaf
    worst = _grad_errors(tgrads, jgrads)
    assert max(worst.values()) <= 1.0, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_10_step_trajectory_matches_jax():
    """Both packages' train steps (remat, chunked next-token loss plus the
    aux, AdamW) for 10 steps on one batch, which they fit: the loss falls
    and follows JAX at TRAJ_REL, the aux too."""
    jcfg, jmodel, params, tmodel = models()
    jrun, trun = _runs(jcfg, tmodel.cfg)
    opt = dict(lr=1e-3, warmup_steps=3, total_steps=10, weight_decay=0.1)
    jstep = jax.jit(jts.make_train_step(jmodel, jrun, joptim.AdamWConfig(**opt)))
    jstate = {"params": params, "opt": joptim.init_opt_state(params)}
    # the port's step updates the parameters in place: it trains a copy
    tmodel2 = build_model(tmodel.cfg, device="cpu")
    tmodel2.load_state_dict(tmodel.state_dict())
    tstep = tts.make_train_step(tmodel2, trun, toptim.AdamWConfig(**opt))
    tstate = tts.init_state(tmodel2, trun, seed=None)
    jl, tl, ta = [], [], []
    b = _batch(200, jcfg.vocab_size)
    for _ in range(10):
        jstate, jm = jstep(jstate, _jbatch(b))
        tstate, tm = tstep(tstate, _tbatch(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        ta.append((tm["aux_loss"].item(), float(jm["aux_loss"])))
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_REL)
    np.testing.assert_allclose(*zip(*ta), rtol=TRAJ_REL)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_serve_cli_runs_the_reduced_model(capsys):
    """``python -m repro_torch.launch.serve --device cpu --reduced --paged
    --arch deepseek-v2-lite-16b``: 4 requests, greedy tokens inside the
    vocabulary."""
    serve_cli.main(["--device", "cpu", "--reduced", "--paged", "--arch", ARCH,
                    "--prompt-len", "20", "--max-new", "6"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}-smoke paged on cpu: 4 requests x 20 prompt + 6 new" in out


def test_train_cli_first_loss_is_the_jax_loss_on_its_batch(tmp_path, one_thread):
    """``main --arch deepseek-v2-lite-16b --reduced`` trains from its seed-0
    parameters; its first loss (the next-token loss plus the aux) equals
    the JAX ``loss_for`` of those parameters on the pipeline's first batch
    with the launcher's rolled labels."""
    data = str(tmp_path / "data")
    argv = ["--device", "cpu", "--reduced", "--arch", ARCH, "--batch", "4", "--seq", "48",
            "--n-functions", "150", "--workers", "2", "--log-every", "1", "--steps", "2",
            "--data-dir", data]
    _, log = cli.main(argv)
    cfg = dataclasses.replace(reduced(get_config(ARCH)), max_position=4096)
    pipe = DataPipeline.build(data, n_functions=150, seq_len=48, batch_size=4,
                              vocab_size=cfg.vocab_size, work_fn=cli.make_work_fn(cfg))
    try:
        first = pipe.peek_batch(0)
    finally:
        pipe.close()
    model = Model(cfg, seed=0, device="cpu")
    jparams = tree_map_paths(lambda path, _: jnp.asarray(model.state_dict()[path].numpy()),
                             model.specs())
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH)), max_position=4096)
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("cli", 48, 4, "train"), sharding="ddp",
                      param_dtype="float32", activation_dtype="float32")
    jloss, jmet = jts.loss_for(jbuild_model(jcfg), jparams,
                               {k: jnp.asarray(v.numpy(), jnp.int32 if k != "loss_mask"
                                               else jnp.float32) for k, v in first.items()},
                               run=jrun)
    assert float(jmet["aux_loss"]) > 0
    np.testing.assert_allclose(log.metrics[0]["loss"], float(jloss), rtol=LOSS_REL)
    assert log.metrics[1]["loss"] != log.metrics[0]["loss"]


def test_launchers_take_the_arch_and_refuse_the_card_here():
    """Both launchers take the arch; without ``--device`` they run on the
    card, which this machine lacks, and raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launchers would run there")
    with pytest.raises(Exception, match="CUDA|cuda"):
        serve_cli.main(["--reduced", "--paged", "--arch", ARCH, "--prompt-len", "8",
                        "--max-new", "2"])


def test_chip_phases_count_the_mla_layers():
    """``chip_smoke.py``'s cut of deepseek (the dense layer 0 and one MoE
    layer: 1.085 G parameters, 583.5 M active) and its launch counts: an
    MLA layer launches the flash kernel in a prefill and in a train step
    (forward, remat, backward) and never the paged kernel, which MLA's
    plain latent decode replaces; v's head dim at 192 is 128."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mla", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    whole, cut = cs.deepseek_cfg(), cs.deepseek_cfg(2)
    assert dataclasses.asdict(whole) == dataclasses.asdict(get_config(ARCH))
    assert (cut.n_layers, scaling.param_count(cut),
            scaling.param_count(cut, active_only=True)) == (2, 1_085_287_424, 583_543_808)
    assert cs.layer_counts(whole) == (27, 0, 0) and cs.layer_counts(cut) == (2, 0, 0)
    assert cs.serve_launches(whole, 8, 31) == {"flash_attention": 27 * 8}
    assert cs.train_launches_per_step(cut, 2, 4096, 2)["flash_attention"] == 8
    assert cs.train_launches_per_step(cut, 2, 4096, 2)["flash_attention_bwd"] == 4
    assert cs.v_dim(192) == 128 and cs.v_dim(128) == 128 and cs.v_dim(256) == 256
    fwd = cs.flash_bound(torch.zeros(1, 4096, 16, 192), torch.zeros(1, 4096, 16, 192), True,
                         lse=False, peak=cs.PEAK_BF16_FLOPS)
    bwd = cs.flash_bwd_bound(torch.zeros(1, 4096, 16, 192), torch.zeros(1, 4096, 16, 192), True,
                             peak=cs.PEAK_BF16_FLOPS)
    pairs = 4096 * 4097 / 2
    assert fwd == (2 * 16 * pairs * (192 + 128) / 989e12 * 1e3, "operations")
    assert bwd[0] == 2 * 16 * pairs * (3 * 192 + 2 * 128) / 989e12 * 1e3
    assert round(fwd[0], 4) == 0.0869

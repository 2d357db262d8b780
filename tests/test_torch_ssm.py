"""The port's Mamba2 serving slice against the JAX package on the CPU: the
plain SSD scan against the Pallas ``ssd_scan`` (interpret mode) and the
chunked oracle, and against the step recurrence; its gradients; the
Mamba2 block in prefill and decode; reduced mamba2-130m loaded leaf for
leaf; greedy tokens of the paged engine against the JAX paged engine with
the Pallas scan on; and the SSM pool layout.  Inputs come from numpy
seeds and go to both packages."""
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro_torch.configs import default_run_config, get_config, reduced
from repro_torch.configs.base import MAMBA, LayerSpec, ShapeConfig, uniform_schedule
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as tssm
from repro_torch.models.model import build_model
from repro_torch.models.params import flatten_tree, from_jax_params
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve.engine import PagedServeEngine

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SSD_TOL = dict(atol=1e-4, rtol=1e-4)      # the JAX ssd kernel tests' bar
TOL = dict(atol=1e-4, rtol=1e-5)          # f32 model outputs, as test_torch_model
LENS = (7, 13, 21, 70)                    # 70 spans three reduced chunks of 32
MAX_NEW = 9
ENGINE_KW = dict(page=8, n_pages=64, max_slots=2)


def _ssd_inputs(seed, B, S, H, P, G, N):
    """The JAX kernel tests' distributions, drawn with numpy."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))      # softplus
    A = -np.exp(rng.standard_normal(H) * 0.5)
    Bm = rng.standard_normal((B, S, G, N))
    Cm = rng.standard_normal((B, S, G, N))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk", [(64, 32), (96, 32), (100, 32), (256, 64)])
def test_plain_ssd_matches_pallas_kernel_and_oracle(S, chunk):
    """G = 2 (heads 0, 1 read group 0; 2, 3 group 1); S = 100 is ragged."""
    inp = _ssd_inputs(S, 2, S, 4, 16, 2, 8)
    y, st = ops.ssd(*_t(inp), chunk)
    for want_y, want_st in (jssd_scan(*_j(inp), chunk=chunk),
                            jref.ssd_ref(*_j(inp), chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **SSD_TOL)
    assert y.dtype == torch.float32 and st.shape == (2, 4, 8, 16)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 100, 4, 16, 2, 8, 32), (1, 64, 2, 8, 1, 16, 64), (2, 70, 6, 16, 3, 8, 32)])
def test_plain_ssd_passes_compose_to_the_scan(B, S, H, P, G, N, chunk):
    """The plain versions of the bf16 kernel's three passes (chunk states
    and decays, the carry, the chunk outputs) compose to ``ref.ssd_ref``;
    the carry's final state matches the Pallas ``ssd_scan`` (interpret
    mode) and the state passes the carry hands on are those the Pallas
    kernel's sequential grid carries (its final state from a prefix of
    the chunks), at the SSD bar."""
    inp = _ssd_inputs(S + G, B, S, H, P, G, N)
    x, dt, A, Bm, Cm = _t(inp)
    U, decay = ref.ssd_chunk_states(x, dt, A, Bm, chunk)
    nc = -(-S // chunk)
    assert U.shape == (B, nc, H, N, P) and decay.shape == (B, nc, H)
    states_in, final = ref.ssd_carry(U, decay)
    y = ref.ssd_chunk_outputs(x, dt, A, Bm, Cm, states_in, chunk)
    want_y, want_st = ref.ssd_ref(x, dt, A, Bm, Cm, chunk)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **SSD_TOL)
    np.testing.assert_allclose(final.numpy(), want_st.numpy(), **SSD_TOL)
    _, jfinal = jssd_scan(*_j(inp), chunk=chunk)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **SSD_TOL)
    for c in range(1, nc):
        _, jstate = jssd_scan(*_j([a[:, :c * chunk] if a.ndim > 1 else a for a in inp]),
                              chunk=chunk)
        np.testing.assert_allclose(states_in[:, c].numpy(), np.asarray(jstate), **SSD_TOL)
    assert torch.equal(states_in[:, 0], torch.zeros_like(states_in[:, 0]))


def test_plain_ssd_matches_step_recurrence():
    """The chunked dual form against the O(1) step run token by token,
    both the port's; the step also against the JAX ``ssd_step``."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, 1, 40, 4, 8, 2, 8)
    y_ref, s_ref = ref.ssd_ref(*_t((x, dt, A, Bm, Cm)), chunk=16)
    state = torch.zeros(1, 4, 8, 8)
    jstate = jnp.zeros((1, 4, 8, 8))
    ys = []
    for t in range(40):
        step = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        y, state = ref.ssd_step(state, *_t(step))
        jy, jstate = jssm.ssd_step(jstate, *_j(step))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_ref.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(state.numpy(), s_ref.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=1e-5, rtol=1e-5)


def test_plain_ssd_with_initial_state_continues_the_scan():
    """Scanning the second half from the first half's final state gives
    the whole scan's outputs: the state carries everything."""
    inp = _t(_ssd_inputs(5, 1, 96, 2, 16, 1, 8))
    y, st = ref.ssd_ref(*inp, chunk=32)
    first = [a[:, :50] if a.dim() > 1 else a for a in inp]
    second = [a[:, 50:] if a.dim() > 1 else a for a in inp]
    y1, s1 = ref.ssd_ref(*first, chunk=32)
    y2, s2 = ref.ssd_ref(*second, chunk=32, initial_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), **SSD_TOL)
    np.testing.assert_allclose(s2.numpy(), st.numpy(), **SSD_TOL)


def test_ssd_gradients_match_jax():
    """The CPU backward (the plain version's autograd, recomputed) against
    the JAX ``ops.ssd`` vjp, for a cotangent on y and on the state."""
    inp = _ssd_inputs(7, 2, 70, 4, 16, 2, 8)
    rng = np.random.RandomState(8)
    gy = rng.standard_normal((2, 70, 4, 16)).astype(np.float32)
    gs = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jops.ssd(*a, 32), *_j(inp))
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    xs = [t.requires_grad_(True) for t in _t(inp)]
    y, st = ops.ssd(*xs, 32)
    torch.autograd.backward((y, st), (torch.from_numpy(gy), torch.from_numpy(gs)))
    for name, t, w in zip(("x", "dt", "A", "B", "C"), xs, want):
        w = np.asarray(w)
        assert np.isfinite(t.grad.numpy()).all(), name
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-4 * np.abs(w).max(),
                                   rtol=1e-4, err_msg=name)


def test_ssd_mask_before_exp_keeps_gradients_finite():
    """Decays so strong that exp(acs_l - acs_s) overflows above the
    diagonal: masking the exponent first keeps every gradient finite."""
    x, dt, A, Bm, Cm = _ssd_inputs(9, 1, 64, 2, 16, 1, 8)
    A = A * 50.0                              # dt |A| L far past 88
    xs = [t.requires_grad_(True) for t in _t((x, dt, A, Bm, Cm))]
    y, st = ops.ssd(*xs, 64)
    (y.sum() + st.sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in xs)


# ---------------------------------------------------------------------------
# the Mamba2 block and the model
# ---------------------------------------------------------------------------


def _cfgs(n_layers=2):
    jcfg = dataclasses.replace(jreduced(jget_config("mamba2-130m")),
                               schedule=juniform(n_layers, JLayerSpec(kind=JMAMBA, has_mlp=False)))
    tcfg = dataclasses.replace(reduced(get_config("mamba2-130m")),
                               schedule=uniform_schedule(n_layers, LayerSpec(kind=MAMBA,
                                                                             has_mlp=False)))
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def models():
    """One JAX-initialised parameter set in both packages; the leaves JAX
    inits to constants (D, gate_norm, norm scales) are re-drawn so every
    leaf carries information."""
    jcfg, tcfg = _cfgs()
    jmodel = jbuild_model(jcfg)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    for path, a in flatten_tree(params).items():
        if path.rsplit(".", 1)[-1] in ("D", "gate_norm", "scale"):
            a[...] = 1.0 + 0.3 * rng.standard_normal(a.shape)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_jax_params(params)
    return jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel


def _layer_params(params, tmodel):
    """Layer 0's mixer in both packages."""
    jp = jax.tree_util.tree_map(lambda a: a[0], params["groups"][0][0]["mixer"])
    tp = {k: v[0] for k, v in tmodel.state_dict().items()
          if k.startswith("groups.0.0.mixer.")}
    return jp, {k.rsplit(".", 1)[-1]: v for k, v in tp.items()}


def test_from_jax_params_carries_every_ssm_leaf(models):
    jcfg, jmodel, params, tmodel = models
    flat = flatten_tree(_np_tree(params))
    sd = tmodel.state_dict()
    assert sorted(sd) == sorted(flat)
    mixer = {k.rsplit(".", 1)[-1] for k in sd if k.startswith("groups.0.0.mixer.")}
    assert mixer == {"w_x", "w_z", "w_B", "w_C", "w_dt", "dt_bias", "A_log", "D",
                     "conv_x", "conv_B", "conv_C", "gate_norm", "w_o"}
    for k, a in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)
    specs = tmodel.specs()
    bad = _np_tree(params)
    del bad["groups"][0][0]["mixer"]["conv_B"]
    with pytest.raises(KeyError, match="missing.*mixer.conv_B"):
        from_jax_params(bad, specs)
    bad = _np_tree(params)
    bad["groups"][0][0]["mixer"]["w_o"] = bad["groups"][0][0]["mixer"]["w_o"][:, :-1]
    with pytest.raises(ValueError, match="mixer.w_o"):
        from_jax_params(bad, specs)


@pytest.mark.parametrize("S", [5, 70])
def test_apply_mamba_prefill_and_decode_match_jax(models, S):
    """One Mamba2 block in f32: the prefill output, conv tails and state
    (JAX with its Pallas scan), then two decode steps from that cache,
    whose tails and state the port writes into the cache in place."""
    jcfg, jmodel, params, tmodel = models
    jp, tp = _layer_params(params, tmodel)
    rng = np.random.RandomState(S)
    h = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jout, jcache = jssm.apply_mamba(jp, jnp.asarray(h), jcfg, mode="prefill",
                                    use_pallas=True)
    tout, tcache = tssm.apply_mamba(tp, torch.from_numpy(h), tmodel.cfg, mode="prefill")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for name in ("conv_x", "conv_B", "conv_C", "state"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **TOL,
                                   err_msg=name)
    assert tcache["state"].dtype == torch.float32
    held = {k: v.clone() for k, v in tcache.items()}
    views = dict(tcache)
    for step in range(2):
        h1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jout, jcache = jssm.apply_mamba(jp, jnp.asarray(h1), jcfg, mode="decode",
                                        cache=jcache)
        tout, tcache = tssm.apply_mamba(tp, torch.from_numpy(h1), tmodel.cfg,
                                        mode="decode", cache=tcache)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        for name in ("conv_x", "conv_B", "conv_C", "state"):
            assert tcache[name] is views[name]          # written in place
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       **TOL, err_msg=name)
    assert not torch.equal(held["state"], tcache["state"])


def test_prefill_logits_match_jax(models):
    """Reduced mamba2-130m (2 layers), 70 tokens: the last logits within
    1e-5 of the largest (JAX with its Pallas scan in interpret mode)."""
    jcfg, jmodel, params, tmodel = models
    toks = np.random.RandomState(70).randint(4, jcfg.vocab_size, (1, 70)).astype(np.int32)
    jlogits, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, use_pallas=True)
    with torch.inference_mode():
        tlogits, _ = tmodel.prefill({"tokens": torch.from_numpy(toks).long()})
    want = np.asarray(jlogits)
    assert np.abs(tlogits.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", [1, 2, 3, 40])
def test_prefill_then_decode_equals_longer_prefill(models, n):
    """Prefill n tokens and decode the rest one at a time: the logits of
    the last token equal those of one prefill of all of them.  n = 1, 2
    are shorter than the conv's K-1 = 3 tails (zeros in front)."""
    jcfg, jmodel, params, tmodel = models
    toks = torch.from_numpy(np.random.RandomState(n).randint(4, jcfg.vocab_size, (1, 45)))
    with torch.inference_mode():
        want, _ = tmodel.prefill({"tokens": toks})
        logits, cache = tmodel.prefill({"tokens": toks[:, :n]})
        for t in range(n, 45):
            logits, cache = tmodel.decode_step(cache, toks[:, t:t + 1],
                                               torch.tensor([t], dtype=torch.int32))
    np.testing.assert_allclose(logits[:, 0].numpy(), want[:, 0].numpy(), **TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(models):
    """The JAX paged engine's greedy tokens with its Pallas SSD scan
    (interpret mode) in prefill, two slots so that slots are reused."""
    jcfg, jmodel, params, tmodel = models
    prompts = [np.random.RandomState(i + 1).randint(4, jcfg.vocab_size, n).tolist()
               for i, n in enumerate(LENS)]
    run = JRunConfig(model=jcfg, shape=JShapeConfig("s", 16, 2, "decode"),
                     sharding="ddp", param_dtype="float32",
                     activation_dtype="float32", use_pallas=True)
    jeng = JPagedServeEngine(model=jmodel, run=run, **ENGINE_KW)
    rids = [jeng.submit(p, MAX_NEW) for p in prompts]
    got = jeng.serve(params)
    return tmodel, prompts, [got[r] for r in rids]


def _engine(tmodel, **kw):
    run = default_run_config(tmodel.cfg, ShapeConfig("s", 16, 2, "decode"))
    return PagedServeEngine(tmodel, run, **{**ENGINE_KW, **kw})


def test_engine_matches_jax_greedy(served):
    tmodel, prompts, want = served
    eng = _engine(tmodel)
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    got = eng.serve()
    assert [got[r] for r in rids] == want
    assert eng.utilization() == 0.0
    assert eng._bucket(70) == 70               # exact-length prefill


def test_engine_staggered_admission_reuses_slots(served):
    """Requests joining mid-flight into reused slots get the JAX engine's
    tokens: a reused slot's conv tails and state are overwritten at
    admission, never carried over."""
    tmodel, prompts, want = served
    eng = _engine(tmodel)
    finished, rids, slots = {}, [], []
    order = [3, 0, 2, 1]
    for step in range(80):
        if step in (0, 1, 4, 6):
            rids.append(eng.submit(prompts[order[len(rids)]], MAX_NEW))
        for req in eng.step():
            finished[req.rid] = req.out
            slots.append(req.slot)
        if len(finished) == len(prompts):
            break
    assert [finished[r] for r in rids] == [want[i] for i in order]
    assert len(set(slots)) == 2 and eng.utilization() == 0.0


def test_launcher_cpu_subprocess_mamba2():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--paged", "--arch", "mamba2-130m", "--batch", "3",
         "--prompt-len", "40", "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "mamba2-130m-smoke paged on cpu: 3 requests x 40 prompt + 4 new" in out.stdout


def test_pool_layout_and_commit_touch_one_slot(models):
    """bf16 pools: the conv tails are bf16 per-slot rows, the state rows
    stay f32; a commit writes its own slot's row and no other."""
    jcfg, jmodel, params, tmodel = models
    pools = tpaged.build_pools(tmodel.cfg, page=8, n_pages=4, max_slots=3,
                               dtype=torch.bfloat16, device="cpu")
    leaves = pools["groups"][0][0]["mixer"]
    K, (_, H, P, G, N) = tmodel.cfg.ssm.d_conv, tssm.ssm_dims(tmodel.cfg)
    assert leaves["state"].shape == (2, 3, H, N, P) and leaves["state"].dtype == torch.float32
    assert leaves["conv_x"].shape == (2, 3, K - 1, H, P)
    assert leaves["conv_B"].shape == leaves["conv_C"].shape == (2, 3, K - 1, G, N)
    assert all(leaves[k].dtype == torch.bfloat16 for k in ("conv_x", "conv_B", "conv_C"))
    for v in leaves.values():
        v.fill_(7.0)
    toks = torch.from_numpy(np.random.RandomState(3).randint(4, jcfg.vocab_size, (1, 21)))
    with torch.inference_mode():
        _, cache = tmodel.prefill({"tokens": toks})
    tpaged.commit_prefill(pools, cache, tmodel.cfg, page=8, slot=1,
                          pages=torch.tensor([1, 2, 3]))
    want = cache["groups"][0][0]["mixer"]
    for k, v in leaves.items():
        assert torch.all(v[:, [0, 2]] == 7.0), k
        torch.testing.assert_close(v[:, 1], want[k][:, 0].to(v.dtype), atol=0, rtol=0)
    assert torch.equal(leaves["state"][:, 1], want["state"][:, 0])   # f32, not rounded


def test_ssd_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; ``ops.ssd`` on CPU tensors runs
    the plain version and counts no launch."""
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd

    inp = _t(_ssd_inputs(0, 1, 40, 2, 16, 1, 8))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ssd_scan_fwd(*inp, 32)
    ops.reset_launch_counts()
    ops.ssd(*inp, 32)
    assert not ops.launch_counts

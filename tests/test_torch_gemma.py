"""The port's gemma3 features against the JAX package on the same
parameters and inputs, in f32: qk-norm, the local rope theta, post-norms
and scaled embeddings; the sliding-window ring (its ragged fill, the
pools' ring leaves and their commit, decode past three windows); and the
paged engine's greedy tokens and logits.

The test model is a reduced gemma3-4b whose pattern is (local with
window 16, global): ``configs.base.reduced`` keeps only the first two
layers of gemma3's pattern, which are both local.  One case runs at
head dim 256 (gemma3's own), one at 64."""
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
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models.transformer import cache_shapes as jcache_shapes
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import paged_cache as jpaged
from repro_torch.configs import default_run_config, get_config, reduced
from repro_torch.configs.base import LayerSpec, ScheduleGroup, ShapeConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model
from repro_torch.models.params import flatten_tree
from repro_torch.models.transformer import cache_shapes
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve.engine import PagedServeEngine

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-5)    # f32 on both sides, summed in other orders
W = 16                              # the reduced local layers' window
NEW_LEAVES = ("mixer.q_norm", "mixer.k_norm", "post1.scale", "post2.scale")


def gemma_cfgs(head_dim: int):
    """(JAX, port) configs of the reduced gemma3 with a (local, global)
    pattern at ``head_dim``."""
    jcfg = dataclasses.replace(
        jreduced(jget_config("gemma3-4b")), head_dim=head_dim,
        schedule=(JScheduleGroup(pattern=(JLayerSpec(window=W), JLayerSpec()),
                                 repeats=1),))
    tcfg = dataclasses.replace(
        reduced(get_config("gemma3-4b")), head_dim=head_dim,
        schedule=(ScheduleGroup(pattern=(LayerSpec(window=W), LayerSpec()),
                                repeats=1),))
    return jcfg, tcfg


def gemma_params(jcfg, seed: int = 0):
    """JAX-initialised numpy parameters with every norm scale (ones at
    init) re-drawn around 1, so that each carries information."""
    jmodel = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(np.array, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for path, a in flatten_tree(params).items():
        if path.rsplit(".", 1)[-1] in ("scale", "q_norm", "k_norm"):
            a[...] = 1.0 + 0.2 * rng.standard_normal(a.shape)
    return jmodel, params


_MODELS = {}


def models(head_dim: int):
    """One parameter set in both packages, built once per head dim."""
    if head_dim not in _MODELS:
        jcfg, tcfg = gemma_cfgs(head_dim)
        jmodel, params = gemma_params(jcfg)
        tmodel = build_model(tcfg, device="cpu")
        tmodel.load_jax_params(params)
        _MODELS[head_dim] = (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                             tmodel)
    return _MODELS[head_dim]


def _tokens(jcfg, S, seed):
    return np.random.RandomState(seed).randint(4, jcfg.vocab_size, (1, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# parameters and the features, one at a time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [64, 256])
def test_from_jax_params_round_trips_new_leaves(head_dim):
    jcfg, _, params, tmodel = models(head_dim)
    flat = flatten_tree(jax.tree_util.tree_map(np.array, params))
    sd = tmodel.state_dict()
    assert sorted(sd) == sorted(flat)
    for pi in range(2):
        for leaf in NEW_LEAVES:
            key = f"groups.0.{pi}.{leaf}"
            assert key in sd, key
    assert sd["groups.0.0.mixer.q_norm"].shape == (1, head_dim)
    for k, a in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)


def test_new_leaves_init_to_ones():
    _, tcfg = gemma_cfgs(64)
    sd = build_model(tcfg, device="cpu", seed=1).state_dict()
    for pi in range(2):
        for leaf in NEW_LEAVES:
            assert torch.all(sd[f"groups.0.{pi}.{leaf}"] == 1), leaf


@pytest.mark.parametrize("head_dim", [64, 256])
@pytest.mark.parametrize("window", [W, None])
def test_qk_norm_and_local_theta_match_jax(head_dim, window):
    """q and k after the projection, qk-norm and the layer's rope theta
    (1e4 in a local layer, 1e6 in a global one)."""
    jcfg, tcfg = gemma_cfgs(head_dim)
    jspec, tspec = JLayerSpec(window=window), LayerSpec(window=window)
    assert tattn._theta(tcfg, tspec) == jattn._theta(jcfg, jspec) \
        == (1e4 if window else 1e6)
    rng = np.random.RandomState(head_dim)
    d, H, Hkv = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads
    p = {"wq": rng.standard_normal((d, H, head_dim)) / 16,
         "wk": rng.standard_normal((d, Hkv, head_dim)) / 16,
         "wv": rng.standard_normal((d, Hkv, head_dim)) / 16,
         "q_norm": 1 + 0.3 * rng.standard_normal(head_dim),
         "k_norm": 1 + 0.3 * rng.standard_normal(head_dim)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    h = rng.standard_normal((2, 7, d)).astype(np.float32)
    pos = np.arange(100, 107, dtype=np.int32)[None]
    jq, jk, jv = jattn._project_qkv(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(h), jcfg)
    tq, tk, tv = tattn._project_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                                    torch.from_numpy(h), tcfg)
    th = jattn._theta(jcfg, jspec)
    for got, want in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(
            tlayers.apply_rope(got, torch.from_numpy(pos), th).numpy(),
            np.asarray(jlayers.apply_rope(want, jnp.asarray(pos), th)), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_embed_scale_norm_and_gated_gelu_match_jax():
    """embed_tokens times sqrt(d), rmsnorm at gemma's eps and the gated
    tanh-GELU MLP, on gemma3's settings."""
    jcfg, tcfg = gemma_cfgs(64)
    assert tcfg.embed_scale and tcfg.gated_mlp and tcfg.mlp_act == "gelu"
    rng = np.random.RandomState(7)
    d, f, V = jcfg.d_model, jcfg.d_ff, jcfg.vocab_size
    emb = {"tokens": rng.standard_normal((V, d)).astype(np.float32)}
    toks = rng.randint(0, V, (2, 9))
    np.testing.assert_allclose(
        tlayers.embed_tokens({"tokens": torch.from_numpy(emb["tokens"])},
                             torch.from_numpy(toks), tcfg, torch.float32).numpy(),
        np.asarray(jlayers.embed_tokens(jax.tree_util.tree_map(jnp.asarray, emb),
                                        jnp.asarray(toks), jcfg, jnp.float32)), **TOL)
    x = rng.standard_normal((2, 5, d)).astype(np.float32) * 3
    sc = {"scale": (1 + 0.2 * rng.standard_normal(d)).astype(np.float32)}
    np.testing.assert_allclose(
        tlayers.apply_norm({"scale": torch.from_numpy(sc["scale"])}, torch.from_numpy(x),
                           tcfg).numpy(),
        np.asarray(jlayers.apply_norm(jax.tree_util.tree_map(jnp.asarray, sc),
                                      jnp.asarray(x), jcfg)), atol=1e-5, rtol=1e-5)
    p = {"wi": rng.standard_normal((d, f)) / 16, "wg": rng.standard_normal((d, f)) / 16,
         "wo": rng.standard_normal((f, d)) / 16}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    np.testing.assert_allclose(
        tlayers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jlayers.apply_mlp(jax.tree_util.tree_map(jnp.asarray, p),
                                     jnp.asarray(x), jcfg)), **TOL)


@pytest.mark.parametrize("head_dim", [64, 256])
def test_train_forward_with_post_norms_matches_jax(head_dim):
    """The whole model in train mode (post1 after the mixer, post2 after
    the MLP, both layers' attention at S past the window): logits."""
    jcfg, jmodel, params, tmodel = models(head_dim)
    toks = _tokens(jcfg, 45, 3)
    want, _, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.no_grad():
        got, _, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()}, mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the ring: fill, cache shapes, pools and commit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,length", [(32, 5), (32, 16), (32, 23), (32, 32), (8, 8),
                                      (9, None), (16, None), (40, None)])
def test_fill_cache_ring_matches_jax(S, length):
    """Ragged fills of a right-padded bucket at lengths below, at and
    above W, and the unpadded fills, against JAX ``_fill_cache``."""
    jcfg, tcfg = gemma_cfgs(64)
    rng = np.random.RandomState(S + (length or 0))
    k = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    want = jattn._fill_cache(jnp.asarray(k), jnp.asarray(v), JLayerSpec(window=W), jcfg,
                             length=None if length is None else jnp.int32(length))
    got = tattn._fill_cache(torch.from_numpy(k), torch.from_numpy(v), LayerSpec(window=W),
                            length=length)
    assert sorted(got) == sorted(want) == ["k", "pos", "v"]
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    assert got["pos"].dtype == torch.int32


@pytest.mark.parametrize("S", [8, 64])
def test_cache_shapes_match_jax(S):
    jcfg, tcfg = gemma_cfgs(256)
    want, _ = jcache_shapes(jcfg, 3, S, jnp.float32)
    got = cache_shapes(tcfg, 3, S, torch.float32)
    for pi in range(2):
        for name, sds in want["groups"][0][pi]["mixer"].items():
            shape, dt = got["groups"][0][pi]["mixer"][name]
            assert shape == sds.shape, (pi, name)
            assert (dt == torch.int32) == (sds.dtype == jnp.int32), (pi, name)


def _leaves(tree):
    return {f"{pi}.{name}": leaf for pi, layer in enumerate(tree["groups"][0])
            for name, leaf in layer["mixer"].items()}


def test_build_pools_and_commit_ring_leaves_match_jax():
    """Pools of a (local, global) model: the ring k, v at full W and the
    ring clock (layers, slots, W) filled with -1; then two padded prefills
    committed into slots 2 and 0, every leaf against JAX."""
    jcfg, jmodel, params, tmodel = models(64)
    page, n_pages, slots = 8, 12, 3
    jpools = jpaged.build_pools(jcfg, page=page, n_pages=n_pages, max_slots=slots)
    tpools = tpaged.build_pools(tmodel.cfg, page=page, n_pages=n_pages, max_slots=slots,
                                device="cpu")
    assert tuple(_leaves(tpools)["0.pos"].shape) == (1, slots, W)
    assert torch.all(_leaves(tpools)["0.pos"] == -1)
    for name, leaf in _leaves(jpools).items():
        np.testing.assert_array_equal(_leaves(tpools)[name].numpy(), np.asarray(leaf))
    for slot, L, pages in ((2, 21, (5, 9, 2)), (0, 6, (7,))):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :L] = _tokens(jcfg, L, L)[0]
        _, jc, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                return_hidden=True, paged={"length": jnp.int32(L)})
        jpools = jpaged.commit_prefill(jpools, jc, jcfg, page=page, slot=slot,
                                       pages=jnp.asarray(pages, jnp.int32))
        with torch.inference_mode():
            _, tc, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()},
                                    mode="prefill", return_hidden=True, paged={"length": L})
            tpaged.commit_prefill(tpools, tc, tmodel.cfg, page=page, slot=slot,
                                  pages=torch.tensor(pages))
    for name, leaf in _leaves(jpools).items():
        got = _leaves(tpools)[name].numpy()
        if name.endswith("pos"):
            np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=name)
        else:
            np.testing.assert_allclose(got, np.asarray(leaf), err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [64, 256])
@pytest.mark.parametrize("S,L,use_pallas", [(40, 37, False), (128, 101, True)])
def test_prefill_matches_jax(head_dim, S, L, use_pallas):
    """A prompt of L tokens right-padded to S: hidden state, the last real
    position's logits and both layers' caches (the local layer's ring).
    At S = 128 the JAX side runs its Pallas flash kernel (interpret
    mode), with the window in the local layer."""
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
    step to position 55 (past 3 W): every tick's logits against JAX's
    decode step (its paged kernel in interpret mode, or its jnp oracle),
    and the last against the port's own full forward."""
    jcfg, jmodel, params, tmodel = models(64)
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
    jpg = {"tables": jnp.asarray(tables), "page": page, "use_pallas": use_pallas}
    tpg = {"tables": torch.from_numpy(tables), "page": page}
    for pos in range(S0, total):
        tok = np.array([[toks[0, pos]], [0]], np.int32)
        p = np.array([pos, 0], np.int32)
        jlogits, jpools = jmodel.decode_step(params, jpools, jnp.asarray(tok),
                                             jnp.asarray(p), paged=jpg)
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


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

LENS = (70, 13, 100, 5)        # shorter and longer than W; 70 and 100 at bucket 128
MAX_NEW = 12                   # the 13- and 5-token prompts' rings wrap in decode
ENGINE_KW = dict(page=8, n_pages=64, max_slots=3)


def _recording(eng, fn, log, key):
    """``fn`` that also logs its logits, for a decode tick only the rows
    of the slots active at the call"""
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        logits = np.asarray(out[0], dtype=np.float32)
        if key == "decode":
            logits = logits[sorted(eng._active), 0]
        log.append((key, logits.reshape(-1, logits.shape[-1])[-1:]
                    if key == "prefill" else logits))
        return out
    return wrapped


_SERVED = {}


def served(use_pallas: bool):
    """The JAX engine's greedy tokens and every prefill's and decode tick's
    logits, staggered: two requests, then two more after two ticks; 3
    slots, so the last waits for a slot."""
    if use_pallas not in _SERVED:
        jcfg, jmodel, params, tmodel = models(64)
        run = JRunConfig(model=jcfg, shape=JShapeConfig("s", 16, 2, "decode"),
                         sharding="ddp", param_dtype="float32",
                         activation_dtype="float32", use_pallas=use_pallas)
        jeng = JPagedServeEngine(model=jmodel, run=run, use_pallas_decode=use_pallas,
                                 **ENGINE_KW)
        _SERVED[use_pallas] = _drive(jeng, lambda: jeng.step(params))
    return _SERVED[use_pallas]


def _drive(eng, step):
    log = []
    eng._prefill = _recording(eng, eng._prefill, log, "prefill")
    eng._decode = _recording(eng, eng._decode, log, "decode")
    jcfg = models(64)[0]
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
    want_tokens, want_log = served(use_pallas)
    _, _, _, tmodel = models(64)
    run = default_run_config(tmodel.cfg, ShapeConfig("s", 16, 2, "decode"))
    eng = PagedServeEngine(tmodel, run, **ENGINE_KW)
    got_tokens, got_log = _drive(eng, eng.step)
    assert got_tokens == want_tokens
    assert [k for k, _ in got_log] == [k for k, _ in want_log]
    assert sum(k == "decode" for k, _ in got_log) > MAX_NEW
    for i, ((kind, got), (_, want)) in enumerate(zip(got_log, want_log)):
        np.testing.assert_allclose(got, want, err_msg=f"{kind} {i}", **TOL)
    assert eng.utilization() == 0.0

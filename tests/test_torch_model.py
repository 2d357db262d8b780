"""The port's model against the JAX package on the same parameters and
inputs, in f32: parameter transfer leaf for leaf, the primitive layers,
and reduced starcoder2-3b at 2 stacked layers through prefill (hidden
state, logits, KV cache) and one paged decode step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import uniform_schedule as juniform
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.serve import paged_cache as jpaged
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import LayerSpec, uniform_schedule
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model
from repro_torch.models.params import flatten_tree, from_jax_params
from repro_torch.serve import paged_cache as tpaged

# the suite runs test files in parallel workers: keep torch's CPU threads few
torch.set_num_threads(2)

# f32 on both sides; the two frameworks sum in different orders
TOL = dict(atol=1e-4, rtol=1e-5)


def _cfgs(n_layers=2):
    jcfg = dataclasses.replace(jreduced(jget_config("starcoder2-3b")),
                               schedule=juniform(n_layers, JLayerSpec()))
    tcfg = dataclasses.replace(reduced(get_config("starcoder2-3b")),
                               schedule=uniform_schedule(n_layers, LayerSpec()))
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def models():
    """One JAX-initialised parameter set in both packages.  Biases and
    norm parameters are re-drawn (JAX inits them to 0 / 1) so that every
    leaf carries information."""
    jcfg, tcfg = _cfgs()
    jmodel = jbuild_model(jcfg)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    flat = flatten_tree(params)
    for path, a in flat.items():
        if path.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "bi", "bo", "bias", "scale"):
            a[...] = (1.0 if path.endswith("scale") else 0.0) \
                + 0.1 * rng.standard_normal(a.shape)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_jax_params(params)
    return jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel


def test_from_jax_params_round_trip(models):
    jcfg, jmodel, params, tmodel = models
    flat = flatten_tree(_np_tree(params))
    sd = tmodel.state_dict()
    assert sorted(sd) == sorted(flat)
    assert "groups.0.0.mixer.wq" in sd and sd["groups.0.0.mixer.wq"].shape[0] == 2
    for k, a in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)


def test_from_jax_params_rejects_mismatch(models):
    jcfg, jmodel, params, tmodel = models
    tree = _np_tree(params)
    specs = tmodel.specs()
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    del bad["final_norm"]["bias"]
    with pytest.raises(KeyError, match="missing.*final_norm.bias"):
        from_jax_params(bad, specs)
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["embed"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra.*embed.extra"):
        from_jax_params(bad, specs)
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["embed"]["tokens"] = bad["embed"]["tokens"][:-1]
    with pytest.raises(ValueError, match="embed.tokens"):
        from_jax_params(bad, specs)


def test_init_is_seeded_and_follows_spec_rules():
    _, tcfg = _cfgs()
    a = build_model(tcfg, device="cpu", seed=3).state_dict()
    b = build_model(tcfg, device="cpu", seed=3).state_dict()
    c = build_model(tcfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["groups.0.0.mixer.wq"], c["groups.0.0.mixer.wq"])
    assert torch.all(a["groups.0.0.mixer.bq"] == 0)
    assert torch.all(a["final_norm.scale"] == 1)
    # normal leaves: std 1/sqrt(fan_in), fan_in ignoring the layers axis
    wi = a["groups.0.0.mlp.wi"]
    assert abs(wi.std().item() * np.sqrt(tcfg.d_model) - 1) < 0.05
    assert abs(a["embed.tokens"].std().item() - 1) < 0.05


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_jax(norm):
    jcfg, tcfg = _cfgs()
    jcfg, tcfg = (dataclasses.replace(c, norm=norm) for c in (jcfg, tcfg))
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(jcfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(jcfg.d_model).astype(np.float32)}
    want = jlayers.apply_norm(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_apply_rope_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e5)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True)])
def test_apply_mlp_matches_jax(act, gated):
    jcfg, tcfg = _cfgs()
    jcfg, tcfg = (dataclasses.replace(c, mlp_act=act, gated_mlp=gated)
                  for c in (jcfg, tcfg))
    rng = np.random.RandomState(3)
    d, f = jcfg.d_model, jcfg.d_ff
    p = {"wi": rng.standard_normal((d, f)) / 16, "wo": rng.standard_normal((f, d)) / 16}
    if gated:
        p["wg"] = rng.standard_normal((d, f)) / 16
    else:
        p["bi"] = rng.standard_normal(f)
        p["bo"] = rng.standard_normal(d)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 4, d)).astype(np.float32)
    want = jlayers.apply_mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got = tlayers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attend_block_matches_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(4)
    q = rng.standard_normal((2, 6, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 64)).astype(np.float32)
    mask = np.where(rng.rand(2, 1, 6, 10) < 0.3, -2e38, 0.0).astype(np.float32)
    mask[..., 0] = 0.0
    want = jattn._attend_block(*map(jnp.asarray, (q, k, v, mask)), jcfg)
    got = tattn._attend_block(*map(torch.from_numpy, (q, k, v, mask)), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the model: prefill and paged decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,use_pallas", [(40, False), (128, True)])
def test_prefill_matches_jax(models, S, use_pallas):
    """Hidden state, last logits and the stacked KV cache.  At S=128 the
    JAX side runs its Pallas flash kernel (interpret mode)."""
    jcfg, jmodel, params, tmodel = models
    toks = np.random.RandomState(S).randint(4, jcfg.vocab_size, (1, S)).astype(np.int32)
    jh, jcache, _ = jmodel.apply(params, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                 return_hidden=True, use_pallas=use_pallas)
    jlogits, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, use_pallas=use_pallas)
    with torch.inference_mode():
        th, tcache, _ = tmodel.apply({"tokens": torch.from_numpy(toks).long()},
                                     mode="prefill", return_hidden=True)
        tlogits, _ = tmodel.prefill({"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache["groups"][0][0]["mixer"][name].numpy(),
            np.asarray(jcache["groups"][0][0]["mixer"][name]), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paged_decode_step_matches_jax(models, use_pallas):
    """Two slots prefilled and committed into fragmented pages, one
    inactive slot on the trash page; then one decode step (JAX: Pallas
    paged kernel in interpret mode, or its jnp oracle)."""
    jcfg, jmodel, params, tmodel = models
    page, n_pages, maxp = 8, 16, 4
    lens = (13, 9)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(4, jcfg.vocab_size, (1, L)).astype(np.int32) for L in lens]
    tables = np.zeros((3, maxp), np.int32)
    tables[0, :2] = (7, 3)
    tables[1, :2] = (12, 5)
    jpools = jpaged.build_pools(jcfg, page=page, n_pages=n_pages, max_slots=3)
    tpools = tpaged.build_pools(tmodel.cfg, page=page, n_pages=n_pages, device="cpu")
    for slot, toks in enumerate(prompts):
        pages = tables[slot, :jpaged.pages_for(toks.shape[1], page)]
        _, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks)})
        jpools = jpaged.commit_prefill(jpools, jc, jcfg, page=page, slot=slot,
                                       pages=jnp.asarray(pages))
        with torch.inference_mode():
            _, tc = tmodel.prefill({"tokens": torch.from_numpy(toks).long()})
            tpaged.commit_prefill(tpools, tc, tmodel.cfg, page=page,
                                  pages=torch.from_numpy(pages).long())
    tok = np.array([[11], [22], [0]], np.int32)
    pos = np.array([lens[0], lens[1], 0], np.int32)
    jlogits, jpools = jmodel.decode_step(
        params, jpools, jnp.asarray(tok), jnp.asarray(pos),
        paged={"tables": jnp.asarray(tables), "page": page, "use_pallas": use_pallas})
    with torch.inference_mode():
        tlogits, tpools = tmodel.decode_step(
            tpools, torch.from_numpy(tok).long(), torch.from_numpy(pos),
            paged={"tables": torch.from_numpy(tables), "page": page})
    np.testing.assert_allclose(tlogits[:2].numpy(), np.asarray(jlogits)[:2], **TOL)
    for name in ("k", "v"):   # the pools, trash page 0 aside
        np.testing.assert_allclose(
            tpools["groups"][0][0]["mixer"][name][:, 1:].numpy(),
            np.asarray(jpools["groups"][0][0]["mixer"][name])[:, 1:], **TOL)


def test_unported_layers_raise():
    _, tcfg = _cfgs()
    windowed = dataclasses.replace(tcfg, schedule=uniform_schedule(1, LayerSpec(window=16)))
    with pytest.raises(NotImplementedError):
        tpaged.build_pools(windowed, page=8, n_pages=4, device="cpu")
    with pytest.raises(NotImplementedError):   # the encoder family is ported (training slice)
        build_model(dataclasses.replace(tcfg, is_encoder_decoder=True), device="cpu")

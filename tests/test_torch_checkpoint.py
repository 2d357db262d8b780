"""The port's checkpoints against the JAX package's on the CPU: the same
on-disk format both ways (a JAX sharded checkpoint of a reduced
bert-mlm state restores into the port leaf for leaf, a port one through
JAX ``restore_sharded`` into ``abstract_state``), the same key set, the
commit and GC rules (torn or garbage manifests and missing shards are
skipped, ``keep_last_k`` spares a pinned step), and an asynchronous save
that the next in-place train step cannot reach."""
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.models.model import build_model
from repro_torch.models.params import flatten_tree, from_jax_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_state, make_train_step

RUN_KW = dict(sharding="ddp", param_dtype="float32", activation_dtype="float32")


@pytest.fixture(scope="module")
def cfgs():
    jcfg = jreduced(jget_config("bert-mlm-120m"))
    tcfg = reduced(get_config("bert-mlm-120m"))
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("c", 16, 2, "train"), **RUN_KW)
    trun = RunConfig(model=tcfg, shape=ShapeConfig("c", 16, 2, "train"), **RUN_KW)
    return jcfg, jrun, tcfg, trun


def _jax_state(jcfg, jrun, seed=0):
    """A JAX train state with moments and step that carry information."""
    jmodel = jbuild_model(jcfg)
    state = jts.init_state(jmodel, jax.random.PRNGKey(seed), jrun)
    rng = np.random.RandomState(seed)
    noise = lambda t: jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), t)
    return jmodel, {"params": state["params"],
                    "opt": {"mu": noise(state["params"]), "nu": noise(state["params"]),
                            "step": np.int32(7)}}


def _port_state(tcfg, trun, seed=3):
    state = init_state(build_model(tcfg, device="cpu", seed=seed), trun, seed=None)
    g = torch.Generator().manual_seed(seed)
    for k in ("mu", "nu"):
        for t in state["opt"][k].values():
            t.copy_(torch.randn(t.shape, generator=g))
    state["opt"]["step"] = torch.tensor(5, dtype=torch.int32)
    return state


def test_jax_checkpoint_restores_into_the_port(cfgs, tmp_path):
    jcfg, jrun, tcfg, trun = cfgs
    jmodel, jstate = _jax_state(jcfg, jrun)
    pstate = {"seed": 0, "global_step": 7}
    jckpt.save_sharded(str(tmp_path), jstate, step=7, pipeline_state=pstate)
    tmodel = build_model(tcfg, device="cpu", seed=11)
    like = init_state(tmodel, trun, seed=None)
    params_before = like["params"]
    got, got_pstate, manifest = ckpt.restore_sharded(str(tmp_path), like)
    assert got is like and got["params"] is params_before     # filled in place
    assert got_pstate == pstate and manifest["step"] == 7
    np_params = jax.tree_util.tree_map(np.asarray, jstate["params"])
    want = from_jax_params(np_params, tmodel.specs())
    sd = got["params"].state_dict()
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    for m in ("mu", "nu"):
        flat = flatten_tree(jax.tree_util.tree_map(np.asarray, jstate["opt"][m]))
        assert sorted(got["opt"][m]) == sorted(flat)
        for k, a in flat.items():
            assert torch.equal(got["opt"][m][k], torch.from_numpy(a)), (m, k)
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 7


def test_port_checkpoint_restores_through_jax(cfgs, tmp_path):
    jcfg, jrun, tcfg, trun = cfgs
    state = _port_state(tcfg, trun)
    ckpt.save_sharded(str(tmp_path / "sharded"), state, step=5)
    ckpt.save(str(tmp_path / "flat" / "ck"), state, step=5)
    like = jts.abstract_state(jbuild_model(jcfg), jrun)
    sharded, _, manifest = jckpt.restore_sharded(str(tmp_path / "sharded"), like)
    flat = jckpt.restore(str(tmp_path / "flat" / "ck"), like)
    assert manifest == {"step": 5, "process_count": 1,
                        "n_arrays": manifest["n_arrays"], "format": 1}
    sd = state["params"].state_dict()
    for got in (sharded, flat):
        for k, a in flatten_tree(jax.tree_util.tree_map(np.asarray, got["params"])).items():
            np.testing.assert_array_equal(a, sd[k].numpy(), err_msg=k)
        for m in ("mu", "nu"):
            for k, a in flatten_tree(jax.tree_util.tree_map(np.asarray, got["opt"][m])).items():
                np.testing.assert_array_equal(a, state["opt"][m][k].numpy(), err_msg=k)
        assert got["opt"]["step"].dtype == np.int32 and int(got["opt"]["step"]) == 5


def test_both_packages_write_the_same_keys(cfgs, tmp_path):
    jcfg, jrun, tcfg, trun = cfgs
    _, jstate = _jax_state(jcfg, jrun)
    jckpt.save_sharded(str(tmp_path / "j"), jstate, step=1)
    ckpt.save_sharded(str(tmp_path / "t"), _port_state(tcfg, trun), step=1)
    files = [np.load(os.path.join(ckpt.step_dir(str(tmp_path / w), 1), "shard-00000.npz"))
             for w in ("j", "t")]
    assert sorted(files[0].files) == sorted(files[1].files)
    assert "opt/step" in files[1].files and "params/groups/0/0/mixer/wq" in files[1].files
    for k in files[0].files:
        assert files[0][k].shape == files[1][k].shape and files[0][k].dtype == files[1][k].dtype, k
    assert sorted(files[1].files) == sorted(jckpt._flatten(jstate)[0])


def test_bf16_leaves_are_stored_as_f32_and_restore_exactly(cfgs, tmp_path):
    _, _, tcfg, _ = cfgs
    run = RunConfig(model=tcfg, shape=ShapeConfig("c", 16, 2, "train"), sharding="ddp",
                    param_dtype="bfloat16", activation_dtype="bfloat16")
    state = init_state(build_model(tcfg, device="cpu", seed=2), run, seed=None)
    ckpt.save_sharded(str(tmp_path), state, step=2)
    with np.load(os.path.join(ckpt.step_dir(str(tmp_path), 2), "shard-00000.npz")) as z:
        wq = z["params/groups/0/0/mixer/wq"]
    assert wq.dtype == np.float32
    np.testing.assert_array_equal(wq, state["params"].groups[0][0].mixer.wq.detach().float().numpy())
    like = init_state(build_model(tcfg, device="cpu", seed=9), run, seed=None)
    got, _, _ = ckpt.restore_sharded(str(tmp_path), like)
    sd, want = got["params"].state_dict(), state["params"].state_dict()
    assert all(sd[k].dtype == torch.bfloat16 and torch.equal(sd[k], want[k]) for k in want)


def _tree(v):
    return {"params": {"w": np.full((2, 3), float(v), np.float32)},
            "opt": {"step": np.int32(v)}}


@pytest.mark.parametrize("tear", ["no_manifest", "garbage_manifest", "truncated_manifest",
                                  "list_manifest", "missing_shard"])
def test_torn_checkpoints_are_skipped(tmp_path, tear):
    base = str(tmp_path)
    ckpt.save_sharded(base, _tree(3), step=3)
    d = ckpt.save_sharded(base, _tree(6), step=6, process_count=2)
    ckpt.save_sharded(base, _tree(6), step=6, process_index=1, process_count=2)
    assert ckpt.latest_step(base) == 6
    mp = os.path.join(d, "manifest.json")
    if tear == "no_manifest":
        os.unlink(mp)
    elif tear == "garbage_manifest":
        with open(mp, "w") as f:
            f.write("\x00not json{")
    elif tear == "truncated_manifest":
        with open(mp, "w") as f:
            f.write(json.dumps({"step": 6})[:-3])
    elif tear == "list_manifest":       # valid JSON, not a commit record
        with open(mp, "w") as f:
            json.dump([6, 2], f)
    else:
        os.unlink(os.path.join(d, "shard-00001.npz"))
    assert ckpt.latest_step(base) == 3
    got, _, manifest = ckpt.restore_sharded(base, _tree(0))
    assert manifest["step"] == 3 and int(got["opt"]["step"]) == 3
    assert ckpt.gc_checkpoints(base, keep_last_k=1) == []   # a torn dir is never counted


def test_keep_last_k_spares_a_pinned_step(tmp_path):
    base = str(tmp_path)
    for s in (2, 4, 6, 8):
        ckpt.save_sharded(base, _tree(s), step=s, keep_last_k=2, pin_steps=(2,))
    assert sorted(os.listdir(base)) == ["ckpt-00000002", "ckpt-00000006", "ckpt-00000008"]
    assert ckpt.gc_checkpoints(base, keep_last_k=1, protect=(2,)) == [6]
    got, _, _ = ckpt.restore_sharded(base, _tree(0), step=2)
    assert int(got["opt"]["step"]) == 2


def test_async_save_keeps_the_pre_step_state(cfgs, tmp_path, monkeypatch):
    """The save returns before the write; the next step then updates the
    state in place, and the writer runs only after it.  What lands on
    disk is still the state at the save."""
    _, _, tcfg, trun = cfgs
    model = build_model(tcfg, device="cpu", seed=1)
    state = init_state(model, trun, seed=None)
    step = make_train_step(model, trun, AdamWConfig(lr=1e-2, warmup_steps=1))
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(4, tcfg.vocab_size, (2, 16), generator=g),
             "labels": torch.randint(4, tcfg.vocab_size, (2, 16), generator=g),
             "loss_mask": torch.ones(2, 16)}
    state, _ = step(state, batch)
    before = {k: v.detach().clone() for k, v in state["params"].state_dict().items()}
    mu_before = {k: v.clone() for k, v in state["opt"]["mu"].items()}
    stepped = threading.Event()
    real_save = ckpt.save_sharded

    def save_after_the_step(*a, **kw):
        assert stepped.wait(timeout=60)
        return real_save(*a, **kw)

    monkeypatch.setattr(ckpt, "save_sharded", save_after_the_step)
    with ckpt.AsyncCheckpointer(str(tmp_path), sharded=True) as saver:
        saver.save(state, step=1)
        state, _ = step(state, batch)
        stepped.set()
        saver.wait()
    assert saver.n_saved == 1 and saver.host_copy_s > 0 and saver.write_s > 0
    after = state["params"].state_dict()
    assert not all(torch.equal(after[k], before[k]) for k in before)   # the step moved them
    like = init_state(build_model(tcfg, device="cpu", seed=5), trun, seed=None)
    got, _, _ = ckpt.restore_sharded(str(tmp_path), like)
    sd = got["params"].state_dict()
    assert all(torch.equal(sd[k], before[k]) for k in before)
    assert all(torch.equal(got["opt"]["mu"][k], mu_before[k]) for k in mu_before)
    assert int(got["opt"]["step"]) == 1


def test_a_sub_sharded_checkpoint_is_refused(tmp_path):
    d = ckpt.save_sharded(str(tmp_path), _tree(1), step=1)
    with open(os.path.join(d, "shard-00000.subshards.json"), "w") as f:
        json.dump({"params/w": {"global_shape": [2, 3], "parts": []}}, f)
    with pytest.raises(NotImplementedError, match="A8"):
        ckpt.restore_sharded(str(tmp_path), _tree(0))


def test_leaf_key_is_the_jax_spelling():
    path = jax.tree_util.tree_flatten_with_path({"opt": {"mu": [{"w": 0}]}})[0][0][0]
    assert ckpt.leaf_key(("opt", "mu", 0, "w")) == jckpt.leaf_key(path) == "opt/mu/0/w"

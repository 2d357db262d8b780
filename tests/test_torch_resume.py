"""Bit-exact resume of the port's ``TrainLoop`` over its ``DataPipeline``
on the CPU, and a resume across packages: the JAX ``TrainLoop``
checkpoints step 3 and the port continues from that checkpoint, on the
losses of the JAX run's own steps 4-6 (``TRAJ_REL`` as in
``test_torch_train.py``).  The batches come from one numpy ``work_fn``
shared by both packages (the masks of ``jax.random`` cannot be matched
by ``torch.Generator``)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import DataPipeline as JDataPipeline
from repro.launch.mesh import make_host_mesh
from repro.models import build_model as jbuild_model
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.runner import StepRunner as JStepRunner
from repro.train.runner import TrainLoop as JTrainLoop
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import DataPipeline
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.runner import StepRunner, TrainLoop, resume

SEQ, B, STEPS, EVERY = 32, 4, 6, 3
TRAJ_REL = 1e-5
VOCAB, MASK_ID = 512, 3
RUN_KW = dict(sharding="ddp", param_dtype="float32", activation_dtype="float32")
OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: with more, MKL and OpenMP size their teams by
    the host's load and a step's sums change order between runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mask_work(batch, rng):
    """BERT masking in numpy from the pipeline's per-batch rng."""
    toks = batch["tokens"]
    sel = (rng.random(toks.shape) < 0.15) & (toks >= 4)
    r = rng.random(toks.shape)
    inputs = np.where(sel & (r < 0.8), MASK_ID, toks)
    inputs = np.where(sel & (r >= 0.8) & (r < 0.9),
                      rng.integers(4, VOCAB, toks.shape), inputs)
    return {"tokens": inputs.astype(np.int32), "labels": toks,
            "loss_mask": sel.astype(np.float32) * batch["attn_mask"]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_resume")
    data = str(tmp / "data")
    build = dict(n_functions=150, seq_len=SEQ, batch_size=B, vocab_size=VOCAB,
                 max_merges=60, network=None, n_workers=2, seed=3, work_fn=mask_work)
    tcfg = dataclasses.replace(reduced(get_config("bert-mlm-120m"), d_model=64),
                               vocab_size=VOCAB, max_position=SEQ)
    trun = RunConfig(model=tcfg, shape=ShapeConfig("t", SEQ, B, "train"), **RUN_KW)

    def make_runner():
        return StepRunner(build_model(tcfg, device="cpu"), trun, AdamWConfig(**OPT_KW))

    return {"tmp": tmp, "data": data, "build": build, "tcfg": tcfg,
            "make_pipe": lambda: DataPipeline.build(data, **build),
            "make_runner": make_runner}


def _losses(log):
    return [m["loss"] for m in log.metrics]


def test_port_resume_repeats_the_uninterrupted_run_bit_for_bit(setup):
    ck = str(setup["tmp"] / "ck_port")
    with setup["make_pipe"]() as p:
        _, full = TrainLoop(setup["make_runner"](), log_every=1).run(p, STEPS, seed=0)
    with setup["make_pipe"]() as p:
        _, first = TrainLoop(setup["make_runner"](), log_every=1, ckpt_dir=ck,
                             ckpt_every=EVERY).run(p, STEPS, seed=0)
    assert _losses(first) == _losses(full)
    assert ckpt.latest_step(ck) == STEPS and os.path.isdir(ckpt.step_dir(ck, EVERY))
    runner = setup["make_runner"]()
    with setup["make_pipe"]() as p:
        state, start = resume(ck, runner, pipeline=p, step=EVERY)
        assert start == EVERY and p.start_step == EVERY
        assert int(state["opt"]["step"]) == EVERY
        with pytest.raises(ValueError, match="positioned at step"):
            TrainLoop(runner).run(p, STEPS, state=state, start_step=0)
        _, rest = TrainLoop(runner, log_every=1).run(p, STEPS, state=state,
                                                     start_step=start)
    assert rest.steps == list(range(EVERY + 1, STEPS + 1))
    assert _losses(rest) == _losses(full)[EVERY:]
    assert rest.telemetry["device_puts"] >= STEPS - EVERY


def test_place_batch_leaves_a_batch_on_the_device_untouched(setup):
    runner = setup["make_runner"]()
    on_device = torch.zeros(2, 3, dtype=torch.int32)
    placed = runner.place_batch({"tokens": on_device, "mask": np.ones((2, 3), np.float32)})
    assert placed["tokens"] is on_device
    assert isinstance(placed["mask"], torch.Tensor) and placed["mask"].device == runner.device


def test_train_loop_takes_batches_already_on_the_device(setup):
    """TrainLoop.run fed batches whose leaves already lie on the state's
    device trains on them as on the same batches in numpy."""
    with setup["make_pipe"]() as p:
        host = [p.peek_batch(k) for k in range(3)]
    placed = [{k: torch.from_numpy(v) for k, v in b.items()} for b in host]
    _, want = TrainLoop(setup["make_runner"](), log_every=1).run(iter(host), 3, seed=0)
    _, got = TrainLoop(setup["make_runner"](), log_every=1).run(iter(placed), 3, seed=0)
    assert _losses(got) == _losses(want) and got.telemetry["device_puts"] == 3


def test_port_resumes_a_jax_checkpoint_on_the_jax_trajectory(setup):
    ck = str(setup["tmp"] / "ck_jax")
    jcfg = dataclasses.replace(jreduced(jget_config("bert-mlm-120m"), d_model=64),
                               vocab_size=VOCAB, max_position=SEQ)
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("t", SEQ, B, "train"), **RUN_KW)
    jrunner = JStepRunner(jbuild_model(jcfg), jrun, JAdamWConfig(**OPT_KW), make_host_mesh())
    with JDataPipeline.build(setup["data"], **setup["build"]) as jp:
        _, jlog = JTrainLoop(jrunner, log_every=1, ckpt_dir=ck,
                             ckpt_every=EVERY).run(jp, STEPS, seed=0)
    assert ckpt.latest_step(ck) == STEPS
    runner = setup["make_runner"]()
    with setup["make_pipe"]() as p:
        state, start = resume(ck, runner, pipeline=p, step=EVERY)
        assert start == EVERY and p.start_step == EVERY
        _, log = TrainLoop(runner, log_every=1).run(p, STEPS, state=state, start_step=start)
    assert log.steps == jlog.steps[EVERY:]
    got, want = np.array(_losses(log)), np.array(_losses(jlog)[EVERY:])
    assert np.all(np.abs(got - want) <= TRAJ_REL * np.abs(want)), (got, want)

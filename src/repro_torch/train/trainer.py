"""Training loop facade: wires a :class:`StepRunner` and the asynchronous
:class:`TrainLoop` together, with the JAX package's ``train()`` call
signature.  This is what a user calls from Python; ``launch/train.py`` drives
the same pieces from the command line.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from repro_torch.configs.base import RunConfig
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.runner import (StepRunner, TrainerLog,  # noqa: F401
                                      TrainLoop, resume)


def train(model: Model, run: RunConfig, opt: AdamWConfig,
          data: Iterable[Dict[str, Any]], *, steps: int,
          seed: int = 0, mesh=None, log_every: int = 10,
          ckpt_path: Optional[str] = None, ckpt_every: int = 0,
          ckpt_dir: Optional[str] = None, start_step: int = 0,
          keep_last_k: int = 0, process_index: int = 0,
          process_count: int = 1, state=None,
          runner: Optional[StepRunner] = None,
          peak_flops: Optional[float] = None) -> tuple:
    """Returns (state, TrainerLog).  Without ``state`` the parameters are
    drawn from ``seed`` on the device of ``model``'s parameters (the card,
    unless the model was built with ``device="cpu"``); a given ``state``
    is trained in place.  ``ckpt_dir`` selects the sharded resumable
    layout (``data`` may be a ``DataPipeline``; its position is
    checkpointed alongside the state — see ``train/checkpoint.py``)."""
    if runner is None:
        runner = StepRunner(model, run, opt, mesh)
    kw = {} if peak_flops is None else {"peak_flops": peak_flops}
    loop = TrainLoop(runner, log_every=log_every, ckpt_path=ckpt_path,
                     ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                     keep_last_k=keep_last_k, process_index=process_index,
                     process_count=process_count, **kw)
    return loop.run(data, steps, state=state, seed=seed, start_step=start_step)

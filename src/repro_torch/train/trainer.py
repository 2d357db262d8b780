"""Training loop facade: wires a :class:`StepRunner` and the asynchronous
:class:`TrainLoop` together, with the JAX package's ``train()`` call
signature.  This is the driver a user calls.

Checkpoint, resume and mesh arguments raise ``NotImplementedError`` until
the slices that port them.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from repro_torch.configs.base import RunConfig
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.runner import StepRunner, TrainerLog, TrainLoop  # noqa: F401


def train(model: Model, run: RunConfig, opt: AdamWConfig,
          data: Iterable[Dict[str, Any]], *, steps: int,
          seed: int = 0, mesh=None, log_every: int = 10,
          ckpt_path: Optional[str] = None, ckpt_every: int = 0,
          ckpt_dir: Optional[str] = None, start_step: int = 0,
          state=None, runner: Optional[StepRunner] = None,
          peak_flops: Optional[float] = None) -> tuple:
    """Returns (state, TrainerLog).  Without ``state`` the parameters are
    drawn from ``seed`` on the device of ``model``'s parameters (the card,
    unless the model was built with ``device="cpu"``); a given ``state``
    is trained in place."""
    if runner is None:
        runner = StepRunner(model, run, opt, mesh)
    kw = {} if peak_flops is None else {"peak_flops": peak_flops}
    loop = TrainLoop(runner, log_every=log_every, ckpt_path=ckpt_path,
                     ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, **kw)
    return loop.run(data, steps, state=state, seed=seed, start_step=start_step)

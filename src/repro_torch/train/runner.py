"""Asynchronous training execution on one device: StepRunner + TrainLoop.

  StepRunner  — owns the train step of ``train_step.make_train_step``, the
                device its state lives on, and the MFU estimate.
  TrainLoop   — drives the runner without blocking the host on the
                device: metric scalars stay on the device until a CUDA
                event recorded after their step reports them done
                (``AsyncMetrics``), so the host keeps enqueueing the next
                steps meanwhile.

Per-step telemetry (step-time EMA, tokens/s, MFU from the analytic 6·N·D
model against the H100's bf16 dense peak, and the host-stall fraction)
rides along in the returned :class:`TrainerLog`, under the JAX package's
names.  Checkpoints, the rollback journal, the straggler monitor, device
prefetch, tracing and the metrics registry of the JAX ``TrainLoop`` come
with later slices; their arguments raise ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.scaling import model_flops
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_state, make_train_step

__all__ = ["StepRunner", "TrainLoop", "TrainerLog", "AsyncMetrics",
           "DEFAULT_PEAK_FLOPS"]

# NVIDIA H100 SXM, bf16 dense tensor-core peak (data sheet); override per card
DEFAULT_PEAK_FLOPS = 989e12


def _not_yet(what: str):
    raise NotImplementedError(f"{what} is not ported yet (training slice 3)")


# ---------------------------------------------------------------------------
# Non-blocking metrics
# ---------------------------------------------------------------------------


class AsyncMetrics:
    """Holds device metric tensors and resolves them to host floats lazily.

    ``push`` never blocks: it records a CUDA event after the step that
    produced the metrics.  ``poll`` resolves only entries whose event the
    device has passed (``Event.query``), so the host keeps enqueueing
    ahead of the device; a bounded pending window (``max_pending``)
    forces resolution of the oldest entry.  ``drain`` resolves everything
    (end of training).  Entries come out in push order.  Metrics on the
    CPU are ready at once.
    """

    def __init__(self, max_pending: int = 8):
        self.max_pending = max_pending
        self._pending: "collections.deque" = collections.deque()
        self.forced_resolves = 0

    @staticmethod
    def _resolve(entry):
        meta, metrics, _ = entry
        return meta, {k: float(v) for k, v in metrics.items()}

    def push(self, meta: Dict[str, Any], metrics: Dict[str, Any]):
        event = None
        if any(isinstance(v, torch.Tensor) and v.is_cuda for v in metrics.values()):
            event = torch.cuda.Event()
            event.record()
        self._pending.append((meta, metrics, event))

    def poll(self) -> List[tuple]:
        out = []
        while len(self._pending) > self.max_pending:
            self.forced_resolves += 1
            out.append(self._resolve(self._pending.popleft()))
        while self._pending and (self._pending[0][2] is None
                                 or self._pending[0][2].query()):
            out.append(self._resolve(self._pending.popleft()))
        return out

    def drain(self) -> List[tuple]:
        out = []
        while self._pending:
            out.append(self._resolve(self._pending.popleft()))
        return out


# ---------------------------------------------------------------------------
# StepRunner
# ---------------------------------------------------------------------------


class StepRunner:
    """Owns the train step and the device of its state (the device of
    ``model``'s parameters).  ``mesh`` must be None: the data-parallel
    runner comes with the DDP slice."""

    def __init__(self, model: Model, run: RunConfig, opt: AdamWConfig, mesh=None):
        if mesh is not None:
            _not_yet("a StepRunner over a mesh (DDP)")
        self.model, self.run, self.opt = model, run, opt
        self.device = next(model.parameters()).device
        self._step = make_train_step(model, run, opt)

    def init_state(self, seed: int = 0):
        return init_state(self.model, self.run, seed)

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's leaves (numpy or tensors) on the state's device."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def __call__(self, state, batch):
        return self._step(state, self.place_batch(batch))

    # -- cost / MFU ------------------------------------------------------
    def flops_per_step(self, tokens_per_step: int) -> float:
        """The analytic 6·N·D model flops of one step."""
        return model_flops(self.model.cfg, tokens_per_step)

    def mfu(self, step_time_s: float, tokens_per_step: int,
            peak_flops: float = DEFAULT_PEAK_FLOPS) -> float:
        if step_time_s <= 0:
            return float("nan")
        return self.flops_per_step(tokens_per_step) / (step_time_s * peak_flops)


# ---------------------------------------------------------------------------
# TrainLoop
# ---------------------------------------------------------------------------


@dataclass
class TrainerLog:
    steps: List[int] = field(default_factory=list)
    metrics: List[Dict[str, float]] = field(default_factory=list)
    samples_per_s: List[float] = field(default_factory=list)
    tokens_per_s: List[float] = field(default_factory=list)
    step_time_ema: List[float] = field(default_factory=list)
    mfu: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)   # host s per iteration
    telemetry: Dict[str, float] = field(default_factory=dict)

    def last(self) -> Dict[str, float]:
        return self.metrics[-1] if self.metrics else {}


class TrainLoop:
    """Asynchronous driver around a :class:`StepRunner`.

    The loop's only synchronous points are the forced resolves of the
    metric window and the final drain; the host time spent blocked is
    ``telemetry['host_blocked_s']`` / ``['stall_fraction']``, and the
    one-time end-of-run drain is ``['drain_s']``, kept out of both."""

    def __init__(self, runner: StepRunner, *, log_every: int = 10,
                 ckpt_path: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_dir: Optional[str] = None, journal=None,
                 straggler_every: int = 0, metrics_lag: int = 8,
                 peak_flops: float = DEFAULT_PEAK_FLOPS):
        if ckpt_path or ckpt_dir or ckpt_every:
            _not_yet("checkpointing")
        if journal is not None:
            _not_yet("the rollback journal")
        if straggler_every:
            _not_yet("the straggler monitor")
        self.runner = runner
        self.log_every = max(1, log_every)
        self.metrics_lag = metrics_lag
        self.peak_flops = peak_flops

    def run(self, data: Iterable[Dict[str, Any]], steps: int, *,
            state=None, seed: int = 0, start_step: int = 0):
        """Run steps ``[start_step, steps)``; returns (state, TrainerLog).
        A given ``state`` is trained in place."""
        if start_step:
            _not_yet("resuming at a later step")
        runner = self.runner
        if state is None:
            state = runner.init_state(seed)
        it = iter(data)
        log = TrainerLog()
        async_metrics = AsyncMetrics(max_pending=self.metrics_lag)
        blocked = 0.0          # host time spent waiting (stalls)
        ema = None
        tokens_per_step = None
        t_start = time.perf_counter()
        t_last_log = t_start
        last_logged = -1

        def resolve_into_log(entries):
            for meta, m in entries:
                log.steps.append(meta["step"])
                log.metrics.append(m)
                log.samples_per_s.append(meta["samples_per_s"])
                log.tokens_per_s.append(meta["tokens_per_s"])
                log.step_time_ema.append(meta["step_time_ema"])
                log.mfu.append(meta["mfu"])

        t_iter = time.perf_counter()
        for i in range(steps):
            tw = time.perf_counter()
            batch = next(it)
            blocked += time.perf_counter() - tw
            if tokens_per_step is None:
                tok = batch["tokens"]
                tokens_per_step = int(tok.shape[0] * tok.shape[1])
            state, metrics = runner(state, batch)
            now = time.perf_counter()
            dt = now - t_iter
            t_iter = now
            log.step_times.append(dt)
            if i > 0:  # the first step pays the kernels' build and warm-up
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if (i + 1) % self.log_every == 0 or i == 0 or i == steps - 1:
                n = i - last_logged
                window = max(now - t_last_log, 1e-9)
                step_t = ema if ema is not None else dt
                meta = {
                    "step": i + 1,
                    "samples_per_s": n * batch["tokens"].shape[0] / window,
                    "tokens_per_s": n * tokens_per_step / window,
                    "step_time_ema": step_t,
                    "mfu": runner.mfu(step_t, tokens_per_step, self.peak_flops),
                }
                async_metrics.push(meta, metrics)
                last_logged = i
                t_last_log = now
                # poll may force-resolve past the lag window, which blocks
                # on the device: account it as stall time
                tw = time.perf_counter()
                resolve_into_log(async_metrics.poll())
                blocked += time.perf_counter() - tw

        tw = time.perf_counter()
        resolve_into_log(async_metrics.drain())
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        drain_s = time.perf_counter() - tw
        total = time.perf_counter() - t_start
        log.telemetry = {
            "total_s": total,
            "host_blocked_s": blocked,
            "stall_fraction": blocked / max(total, 1e-9),
            "drain_s": drain_s,
            "step_time_ema": ema if ema is not None else float("nan"),
            "step_time_p50": float(np.median(log.step_times[1:]))
            if len(log.step_times) > 1 else float("nan"),
            "tokens_per_s": steps * (tokens_per_step or 0) / max(total, 1e-9),
            "forced_metric_resolves": async_metrics.forced_resolves,
        }
        return state, log

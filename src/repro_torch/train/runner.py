"""Asynchronous training execution on one device: StepRunner + TrainLoop.

  StepRunner  — owns the train step of ``train_step.make_train_step``, the
                device its state lives on, and the MFU estimate.
  TrainLoop   — drives the runner without blocking the host on the
                device: batches arrive through the pinned, side-stream
                ``data.device_prefetch`` (a ``DataPipeline`` hands its own
                out), metric scalars stay on the device until a CUDA
                event recorded after their step reports them done
                (``AsyncMetrics``), and checkpoints are serialised on a
                background thread (``checkpoint.AsyncCheckpointer``).

Per-step telemetry (step-time EMA, tokens/s, MFU from the analytic 6·N·D
model against the H100's bf16 dense peak, and the host-stall fraction)
rides along in the returned :class:`TrainerLog`, under the JAX package's
names; the loop's phases are spans of the installed tracer
(``docs/observability.md``).  :func:`resume` restores a sharded
checkpoint and re-aims the pipeline, so the continued run repeats the
uninterrupted one.  The rollback journal and the straggler monitor
(ROADMAP A12) and a mesh (A5) raise ``NotImplementedError``.
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
from repro_torch.data.device_prefetch import DevicePrefetch, as_tensors, on_device
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.model import Model
from repro_torch.observability import STEP_TIME_BUCKETS_MS, get_tracer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.faults import fault_point
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_state, make_train_step

__all__ = ["StepRunner", "TrainLoop", "TrainerLog", "AsyncMetrics", "resume",
           "DEFAULT_PEAK_FLOPS"]

# NVIDIA H100 SXM, bf16 dense tensor-core peak (data sheet); override per card
DEFAULT_PEAK_FLOPS = 989e12


def _not_yet(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


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
            _not_yet("a StepRunner over a mesh (DDP)", "A5")
        self.model, self.run, self.opt = model, run, opt
        self.device = next(model.parameters()).device
        self._step = make_train_step(model, run, opt)

    def init_state(self, seed: int = 0):
        return init_state(self.model, self.run, seed)

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's leaves (numpy or tensors) on the state's device; a
        leaf already there (from the device prefetch) is left untouched."""
        return {k: v if on_device(v, self.device) else v.to(self.device, non_blocking=True)
                for k, v in as_tensors(batch).items()}

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

    The loop's only synchronous points are the host copy before a
    checkpoint (the next step updates the state in place), the forced
    resolves of the metric window and the final drain; the host time
    spent blocked is ``telemetry['host_blocked_s']`` /
    ``['stall_fraction']``, and the one-time end-of-run drain is
    ``['drain_s']``, kept out of both.

    Checkpoints come in the JAX package's two shapes: the flat
    single-file ``ckpt_path``, and the resumable sharded ``ckpt_dir``
    (each process writes only its own ``ckpt-<step>/shard-<pidx>.npz``);
    when ``data`` is a :class:`~repro_torch.data.pipeline.DataPipeline`
    its position rides along, so a later ``run(..., start_step=s)`` on
    the restored state (:func:`resume`) replays the uninterrupted
    trajectory.  ``pin_steps`` lists checkpoint steps ``keep_last_k``
    GC must never prune (the step a pinned resume restored from).

    Observability (optional): ``tracer`` overrides the process-wide
    :func:`~repro_torch.observability.get_tracer`; every phase the loop
    times for stall accounting (data wait, dispatch, metrics resolve and
    drain, checkpoint commit, the final device block) is a span with the
    SAME clock readings, plus a ``step`` span per iteration.  ``metrics``
    is a :class:`~repro_torch.observability.MetricsRegistry` given the
    step-time histogram, per-window throughput gauges and the final
    telemetry (``train_*`` series); ``metrics_jsonl`` appends a registry
    snapshot per log window and at the end.
    """

    def __init__(self, runner: StepRunner, *, log_every: int = 10,
                 ckpt_path: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_dir: Optional[str] = None, keep_last_k: int = 0,
                 pin_steps: tuple = (), process_index: int = 0,
                 process_count: int = 1, metrics_lag: int = 8,
                 journal=None, straggler_every: int = 0,
                 peak_flops: float = DEFAULT_PEAK_FLOPS,
                 tracer=None, metrics=None,
                 metrics_jsonl: Optional[str] = None):
        if ckpt_path and ckpt_dir:
            raise ValueError("pass ckpt_path (flat) or ckpt_dir (sharded), "
                             "not both")
        if journal is not None:
            _not_yet("the rollback journal", "A12")
        if straggler_every:
            _not_yet("the straggler monitor", "A12")
        self.runner = runner
        self.log_every = max(1, log_every)
        self.ckpt_path, self.ckpt_every = ckpt_path, ckpt_every
        self.ckpt_dir = ckpt_dir
        self.keep_last_k = keep_last_k
        self.pin_steps = tuple(pin_steps)
        self.process_index = process_index
        self.process_count = process_count
        self.metrics_lag = metrics_lag
        self.peak_flops = peak_flops
        self.tracer = tracer
        self.metrics = metrics
        self.metrics_jsonl = metrics_jsonl

    def run(self, data: Iterable[Dict[str, Any]], steps: int, *,
            state=None, seed: int = 0, start_step: int = 0):
        """Run steps ``[start_step, steps)``; returns (state, TrainerLog).
        A given ``state`` is trained in place.

        ``start_step`` > 0 is the resume path: ``state`` should be the
        restored checkpoint and, when ``data`` is a DataPipeline, its
        ``restore()`` must have been aimed at the same step."""
        runner = self.runner
        if state is None:
            state = runner.init_state(seed)

        pipeline: Optional[DataPipeline] = None
        if isinstance(data, DataPipeline):
            pipeline = data
            if pipeline.start_step != start_step:
                raise ValueError(
                    f"pipeline positioned at step {pipeline.start_step} "
                    f"but loop starts at {start_step}")
            prefetch = pipeline.device_batches(runner.device)
        else:
            prefetch = DevicePrefetch(data, device=runner.device)
        it = iter(prefetch)

        log = TrainerLog()
        async_metrics = AsyncMetrics(max_pending=self.metrics_lag)
        saver = None
        if self.ckpt_dir:
            saver = ckpt.AsyncCheckpointer(
                self.ckpt_dir, sharded=True,
                process_index=self.process_index,
                process_count=self.process_count,
                keep_last_k=self.keep_last_k, pin_steps=self.pin_steps)
        elif self.ckpt_path:
            saver = ckpt.AsyncCheckpointer(self.ckpt_path)
        saver_stats = None

        tracer = self.tracer if self.tracer is not None else get_tracer()
        step_hist = self.metrics.histogram(
            "train_step_time_ms", STEP_TIME_BUCKETS_MS,
            help="per-step wall time") if self.metrics is not None else None

        blocked = 0.0          # host time spent waiting (stalls)
        data_wait = 0.0        # the part of it spent waiting for a batch
        drain_s = 0.0          # end-of-run metric drain (NOT steady stall)
        ema = None
        tokens_per_step = None
        t_start = time.perf_counter()
        t_last_log = t_start
        last_logged = start_step - 1
        last_saved = -1

        def resolve_into_log(entries):
            for meta, m in entries:
                log.steps.append(meta["step"])
                log.metrics.append(m)
                log.samples_per_s.append(meta["samples_per_s"])
                log.tokens_per_s.append(meta["tokens_per_s"])
                log.step_time_ema.append(meta["step_time_ema"])
                log.mfu.append(meta["mfu"])

        def write_ckpt(st, step_no):
            pstate = pipeline.state_at(step_no).to_json() \
                if pipeline is not None else None
            saver.save(st, step=step_no, pipeline_state=pstate)

        try:
            t_iter = time.perf_counter()
            for i in range(start_step, steps):
                # t_step0 anchors this iteration's "step" span; every
                # blocked component below hands the SAME perf_counter
                # readings to tracer.complete, so the trace is the stall
                # accounting
                t_step0 = tw = time.perf_counter()
                batch = next(it)
                t1 = time.perf_counter()
                blocked += t1 - tw
                data_wait += t1 - tw
                tracer.complete("data_wait", "data", tw, t1)
                if tokens_per_step is None:
                    tok = batch["tokens"]
                    tokens_per_step = int(tok.shape[0] * tok.shape[1])

                tw = time.perf_counter()
                state, metrics = runner(state, batch)
                tracer.complete("dispatch", "compute", tw, time.perf_counter())
                # the host-kill window: step i dispatched, the device
                # possibly still mid-backward
                fault_point("step", i)

                now = time.perf_counter()
                dt = now - t_iter
                t_iter = now
                log.step_times.append(dt)
                if i > start_step:  # the first step pays the kernels' load and warm-up
                    ema = dt if ema is None else 0.9 * ema + 0.1 * dt

                if (i + 1) % self.log_every == 0 or i == start_step \
                        or i == steps - 1:
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
                    # poll may force-resolve past the lag window, which
                    # blocks on the device: account it as stall time
                    tw = time.perf_counter()
                    resolve_into_log(async_metrics.poll())
                    t1 = time.perf_counter()
                    blocked += t1 - tw
                    tracer.complete("metrics_resolve", "metrics", tw, t1)
                    if self.metrics is not None:
                        self.metrics.set_gauges(meta, prefix="train_")
                        if self.metrics_jsonl:
                            self.metrics.write_jsonl(self.metrics_jsonl, step=i + 1)

                if saver is not None and self.ckpt_every \
                        and (i + 1) % self.ckpt_every == 0:
                    tw = time.perf_counter()
                    write_ckpt(state, i + 1)
                    t1 = time.perf_counter()
                    blocked += t1 - tw
                    tracer.complete("ckpt_commit", "ckpt", tw, t1, step=i + 1)
                    last_saved = i + 1

                tracer.complete("step", "loop", t_step0, time.perf_counter(), step=i)
                if step_hist is not None and i > start_step:
                    step_hist.observe(dt * 1e3)

            # the end-of-run drain is NOT steady-state stall: it resolves
            # every still-pending metric window at once, a cost paid once
            tw = time.perf_counter()
            resolve_into_log(async_metrics.drain())
            t_drained = time.perf_counter()
            drain_s = t_drained - tw
            tracer.complete("metrics_drain", "metrics", tw, t_drained)
            if runner.device.type == "cuda":
                torch.cuda.synchronize(runner.device)
            t_blocked = time.perf_counter()
            tracer.complete("device_block", "compute", t_drained, t_blocked)
            # steps > start_step: a resumed run with nothing to do must not
            # rewrite an existing checkpoint under another step number
            final_ckpt = saver is not None and last_saved != steps \
                and steps > start_step
            if final_ckpt:
                write_ckpt(state, steps)
            if saver is not None:
                saver.close()
                saver_stats, saver = saver, None
            t1 = time.perf_counter()
            if final_ckpt:
                tracer.complete("ckpt_commit", "ckpt", t_blocked, t1, step=steps)
            blocked += t1 - t_drained
        finally:
            if saver is not None:  # exception path: still flush the queue
                saver.close()
            prefetch.close()    # stops the pipeline loader this run started

        total = time.perf_counter() - t_start
        n_steps = steps - start_step
        log.telemetry = {
            "total_s": total,
            "host_blocked_s": blocked,
            "stall_fraction": blocked / max(total, 1e-9),
            "data_wait_s": data_wait,
            "drain_s": drain_s,
            "step_time_ema": ema if ema is not None else float("nan"),
            "step_time_p50": float(np.median(log.step_times[1:]))
            if len(log.step_times) > 1 else float("nan"),
            "tokens_per_s": n_steps * (tokens_per_step or 0) / max(total, 1e-9),
            "forced_metric_resolves": async_metrics.forced_resolves,
            "device_puts": prefetch.puts,
            "ckpt_saves": saver_stats.n_saved if saver_stats else 0,
            "ckpt_host_copy_s": saver_stats.host_copy_s if saver_stats else 0.0,
            "ckpt_write_s": saver_stats.write_s if saver_stats else 0.0,
        }
        if self.metrics is not None:
            self.metrics.set_gauges(log.telemetry, prefix="train_")
            if self.metrics_jsonl:
                self.metrics.write_jsonl(self.metrics_jsonl, step=steps,
                                         extra={"final": True})
        return state, log


def resume(ckpt_dir: str, runner: StepRunner, *, pipeline=None,
           process_index: int = 0, step: Optional[int] = None):
    """Restore this process's latest (or given) sharded checkpoint.

    Returns ``(state, start_step)``, ready for ``TrainLoop.run(pipeline,
    total_steps, state=state, start_step=start_step)``.  The state is
    ``init_state(model, run, seed=None)`` (a copy of the runner model's
    parameters on its device) filled in place from the shard.  When
    ``pipeline`` is given it is re-aimed at the checkpoint's input
    position (and the stored layout is checked against it)."""
    like = init_state(runner.model, runner.run, seed=None)
    state, pstate, manifest = ckpt.restore_sharded(
        ckpt_dir, like, step=step, process_index=process_index)
    if pipeline is not None:
        if pstate is None:
            raise ValueError(
                f"checkpoint step {manifest['step']} has no pipeline state")
        pipeline.restore(pstate)
    return state, manifest["step"]

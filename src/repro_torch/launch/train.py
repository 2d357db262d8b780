"""Training launcher: the paper's pretraining run, on one card or data
parallel over several processes.

  PYTHONPATH=src python -m repro_torch.launch.train --arch bert-mlm-120m \\
      --steps 200 --batch 32 --seq 512 [--workers 0] \\
      [--ckpt-dir runs/ck --ckpt-every 50 --keep-last-k 3] [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 20 --batch 8 --seq 64 --n-functions 300
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 200 --batch 16 --seq 1024
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --batch 16 --seq 512 [--grad-bucket-mb 25]
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --sharding fsdp --batch 16 --seq 512

The twin of the JAX package's ``launch/train.py``, with its flags,
defaults (f32 parameters and activations through
``default_run_config``) and printed lines: synthesize a binary-function
corpus, tokenize and pack it (R1), stage it node-locally (R2), auto-tune
the loader workers off the step time measured on a scratch state (R3,
``--workers 0``), then pretrain through ``StepRunner``/``TrainLoop`` with
the batches moved to the card by the pinned, side-stream device
prefetch.  ``--ckpt-dir`` writes resumable per-process shard checkpoints
in the JAX package's format (``ckpt-<step>/shard-<pidx>.npz`` +
manifest; ``--keep-last-k`` prunes older committed ones) and
``--resume`` continues bit for bit from the newest complete one, or from
``--ckpt-step N`` (pinned against GC for the rest of the run).
``--process-index/--process-count`` set this host's slice of the
deterministic global batch order (by default the process group's rank
and size).

Data parallelism (``--sharding ddp``, the default): started by
``torchrun`` (or with the JAX package's ``REPRO_COORDINATOR``,
``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``), every process joins the
process group (``distributed.maybe_initialize_distributed``, printed as
the ``[dist]`` line with its backend), trains ``--batch`` rows of a
global batch of ``--batch`` x processes, and the gradients are summed by
one all-reduce per reverse-layer bucket of ``--grad-bucket-mb``.  On
the card only rank 0 builds the kernels, and the others load them after
a barrier.

fsdp (``--sharding fsdp``, ZeRO-3, the JAX ``scatter_overlap``): the
same processes, but each keeps only its slice of every parameter and
AdamW moment; one all-gather a bucket rebuilds the full parameters in
the forward and one reduce-scatter a bucket returns the summed gradient
shards in the backward.  Its checkpoints hold each process's slices
(``shard-<pidx>.subshards.json`` beside the npz, the JAX format), and
``--resume`` restores them onto the same plan and process count.  The
``[plan]`` line prints the gather volume (``gather=...MB``) and
``[gradsync]`` the collectives issued a step.

Runs on the card unless ``--device cpu`` asks for the CPU (the kernels'
plain versions; ``--reduced`` makes that quick).  ``--sharding`` takes
``ddp`` and ``fsdp``, and the JAX launcher's other parallel, journal and
straggler flags exit with the ROADMAP item that brings them.
``main(argv)`` returns ``(state, TrainerLog)``, so the same run can be
driven in process.  An encoder trains on BERT masks, any other model
(mamba2-130m, say) on the JAX launcher's next-token labels: the tokens
rolled by one, the attention mask as the loss mask.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import default_run_config, get_config
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.mlm import mask_tokens
from repro_torch.data import DataPipeline, NetworkFS
from repro_torch.data.tokenizer import MASK
from repro_torch.distributed import maybe_initialize_distributed
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.observability import MetricsRegistry, Tracer, set_tracer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.runner import StepRunner, TrainLoop, resume

# the JAX launcher's flags that the port cannot honour yet, each with the
# ROADMAP item that brings it; none is ignored silently
REFUSED_FLAGS = {
    "--pipeline-stages": "A11", "--expert-parallel": "A11",
    "--tensor-parallel": "A11", "--pp-schedule": "A11",
    "--elastic-restore": "A12",
    "--journal-dir": "A12", "--journal-k": "A12",
    "--straggler-every": "A12", "--straggler-ratio": "A12",
}
SHARDING_ITEMS = {"tp": "A11", "fsdp_tp": "A11", "pp": "A11", "pp_dp": "A11"}
PROBE_STEPS = 3        # timed steps of the R3 probe, after one warm-up step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="bert-mlm-120m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16,
                    help="per-host batch size")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale model (CPU-friendly)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--workers", type=int, default=0,
                    help="loader workers; 0 = auto-tune (R3)")
    ap.add_argument("--n-functions", type=int, default=3000)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--data-seed", type=int, default=0,
                    help="pipeline order/augmentation seed")
    ap.add_argument("--ckpt", default=None,
                    help="flat single-file checkpoint path (legacy)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="sharded resumable checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="background-save every N steps (0 = final only)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest complete checkpoint "
                         "in --ckpt-dir")
    ap.add_argument("--ckpt-step", type=int, default=None,
                    help="with --resume: restore this exact step instead "
                         "of the newest complete one")
    ap.add_argument("--keep-last-k", type=int, default=0,
                    help="prune committed checkpoints beyond the newest "
                         "K after each save (0 = keep all)")
    ap.add_argument("--sharding", default="ddp",
                    choices=["ddp", "fsdp", *SHARDING_ITEMS],
                    help="parallelism mode; ddp (data parallel, one process "
                         "a shard) and fsdp (ddp with the parameters and "
                         "moments cut over the processes) are ported")
    ap.add_argument("--grad-bucket-mb", type=float, default=25.0,
                    help="gradient all-reduce bucket size (MB); one "
                         "all-reduce per bucket, issued during the backward")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="grad-accumulation split of the local batch "
                         "(0 = no split)")
    ap.add_argument("--process-index", type=int, default=None)
    ap.add_argument("--process-count", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--trace-dir", default=None,
                    help="write a Perfetto-loadable span timeline to "
                         "<dir>/trace-<pidx>.json (docs/observability.md)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append a metrics-registry snapshot line per "
                         "log window (and a final one) to this file")
    for flag, item in REFUSED_FLAGS.items():
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=f"not ported yet (ROADMAP {item})")
    return ap


def _refuse_unported(ap: argparse.ArgumentParser, args) -> None:
    for flag, item in REFUSED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported yet (ROADMAP {item})")
    if args.sharding in SHARDING_ITEMS:
        ap.error(f"--sharding {args.sharding} is not ported yet "
                 f"(ROADMAP {SHARDING_ITEMS[args.sharding]}); the port "
                 "runs ddp and fsdp")


def make_work_fn(cfg, process_index: int = 0, process_count: int = 1):
    """The per-batch ``work_fn`` the loader workers run: for an encoder,
    BERT masking by ``core.mlm.mask_tokens`` on a CPU ``torch.Generator``
    seeded from the pipeline's per-batch rng (so the masked stream is a
    pure function of the cursor); for a decoder, next-token labels.  With
    several processes the draws are made for the whole global batch and
    this host's rows taken from them, so the hosts' masks together are
    those one process draws for the same global batch."""
    is_mlm = cfg.family == "encoder"

    def work(batch, rng):
        toks = torch.from_numpy(batch["tokens"])
        attn = torch.from_numpy(batch["attn_mask"])
        if not is_mlm:
            return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
                    "loss_mask": attn}
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        b = toks.shape[0]
        rows = slice(process_index * b, (process_index + 1) * b)
        full = toks.new_zeros((b * process_count, toks.shape[1]))
        full[rows] = toks
        inputs, labels, mask = mask_tokens(gen, full, cfg.vocab_size, MASK)
        return {"tokens": inputs[rows], "labels": labels[rows],
                "loss_mask": mask[rows] * attn}

    return work


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    # the process group first (env-keyed; a no-op for one process)
    info = maybe_initialize_distributed(args.device)
    device = info.device
    if info.backend is not None:
        print(f"[dist] torch.distributed initialized: process "
              f"{info.rank}/{info.world} backend={info.backend} device={device}")
    # One intra-op thread, on either device.  On the card the host only
    # launches kernels and feeds batches, while the loader workers mask
    # each batch with small torch ops of their own, which a pool of every
    # core would oversubscribe.  On the CPU, more than one thread lets
    # MKL and OpenMP size their teams by the host's load, so a step's sums
    # change order between runs and a resumed run would not repeat the
    # uninterrupted one bit for bit.
    torch.set_num_threads(1)
    if args.process_index is None:
        args.process_index = info.rank
    if args.process_count is None:
        args.process_count = info.world
    pidx, pcount = args.process_index, args.process_count

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    cfg = dataclasses.replace(cfg, max_position=max(cfg.max_position, args.seq))

    data_dir = args.data_dir or tempfile.mkdtemp(prefix="repro_data_")
    print(f"[data] building pipeline in {data_dir} "
          f"(host {pidx}/{pcount}, per-host batch {args.batch})")
    t0 = time.perf_counter()
    # one data dir for the whole group: rank 0 builds it, the others reuse it
    if info.world > 1 and info.rank != 0:
        dist.barrier()
    pipeline = DataPipeline.build(
        data_dir, n_functions=args.n_functions, seq_len=args.seq,
        batch_size=args.batch, vocab_size=cfg.vocab_size,
        network=NetworkFS(agg_bw=2e9, readers=8),
        seed=args.data_seed, process_index=pidx, process_count=pcount,
        n_workers=max(1, args.workers),
        work_fn=make_work_fn(cfg, pidx, pcount))
    if info.world > 1 and info.rank == 0:
        dist.barrier()
    print(f"[R1+R2] packed+staged {pipeline.ds.n_examples} examples "
          f"({pipeline.batches_per_epoch} global batches/epoch) "
          f"in {time.perf_counter() - t0:.2f}s")
    # observability: the tracer is installed before the loader workers
    # start, so they pick it up; the previous one comes back at the end
    tracer = Tracer(process_index=pidx) if args.trace_dir else None
    prev_tracer = set_tracer(tracer) if tracer is not None else None
    try:
        return _train(args, cfg, device, pipeline, tracer, info.world)
    finally:
        pipeline.close()
        if tracer is not None:
            set_tracer(prev_tracer)


def _build_kernels(device, world: int) -> None:
    """On the card with several processes: rank 0 builds every kernel while
    the others wait at a barrier, then load what it built (two ranks
    would otherwise run nvcc for the same libraries)."""
    if device.type != "cuda" or world <= 1:
        return
    if dist.get_rank() == 0:
        from repro_torch.kernels import _build

        _build.build_all()
    dist.barrier()


def _train(args, cfg, device, pipeline, tracer, world: int):
    pidx, pcount = args.process_index, args.process_count
    registry = MetricsRegistry()
    _build_kernels(device, world)
    model = build_model(cfg, device=device)
    # every process of the group trains --batch rows of one global batch
    gbatch = args.batch * world
    run = default_run_config(cfg, ShapeConfig("cli", args.seq, gbatch, "train"),
                             sharding=args.sharding, microbatch=args.microbatch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                      total_steps=args.steps)
    runner = StepRunner(model, run, opt, grad_bucket_mb=args.grad_bucket_mb)
    gs = runner.grad_sync_info()
    print(f"[plan] mode={gs['mode']} dp_axes={gs['dp_axes']} "
          f"dp_size={gs['dp_size']} grad_sync={gs['grad_sync']} "
          f"buckets={gs['n_buckets']} "
          f"comm={gs['comm_bytes']/1e6:.1f}MB/step "
          f"wire={gs['wire_bytes_per_device']/1e6:.1f}MB/dev "
          f"gather={gs['param_gather_bytes']/1e6:.1f}MB")
    if gs.get("fallback_reason"):
        print(f"[plan] fallback: {gs['fallback_reason']}")
    print(f"[plan] device={runner.device} param_dtype={run.param_dtype} "
          f"activation_dtype={run.activation_dtype} microbatch={run.microbatch or 1} "
          f"global_batch={gbatch}")

    probe_steps = 0
    if args.workers == 0:
        # R3 end-to-end: time the real step on a scratch state (so the
        # training trajectory, and resume determinism, are untouched),
        # then grow the loader workers until the consumer stops stalling,
        # and no more
        scratch = runner.init_state(seed=123)
        probe_batch = runner.place_batch(pipeline.peek_batch())
        scratch, _ = runner(scratch, probe_batch)       # kernels' load, warm-up
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(PROBE_STEPS):
            scratch, _ = runner(scratch, probe_batch)
        _sync(device)
        step_time = (time.perf_counter() - t0) / PROBE_STEPS
        probe_steps = 1 + PROBE_STEPS
        del scratch, probe_batch
        tuned = pipeline.autotune(step_time_s=step_time, n_batches=12)
        print(f"[R3] step={step_time*1e3:.1f}ms -> auto-tuned "
              f"workers={tuned['n_workers']} "
              f"device_prefetch={tuned['device_prefetch']} "
              f"(stall={tuned['stall_fraction']:.2f})")

    state, start_step = None, 0
    if args.resume:
        step_arg = args.ckpt_step
        if step_arg is None and ckpt.latest_step(args.ckpt_dir) is None:
            print(f"[resume] no complete checkpoint in {args.ckpt_dir}; "
                  "starting fresh")
        else:
            state, start_step = resume(args.ckpt_dir, runner, pipeline=pipeline,
                                       process_index=pidx, step=step_arg)
            print(f"[resume] host {pidx} restored shard at step "
                  f"{start_step} from {args.ckpt_dir}")

    # a pinned --ckpt-step is an operator decision (a rollback point):
    # protect it from keep-last-k GC for the rest of this run
    pins = (args.ckpt_step,) if (args.resume and args.ckpt_step is not None) else ()
    loop = TrainLoop(runner, log_every=args.log_every,
                     ckpt_path=args.ckpt, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every if (args.ckpt or args.ckpt_dir) else 0,
                     keep_last_k=args.keep_last_k, pin_steps=pins,
                     process_index=pidx, process_count=pcount,
                     metrics=registry, metrics_jsonl=args.metrics_jsonl)
    print(f"[train] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} on {runner.device}, "
          f"{world} process(es), steps {start_step}->{args.steps}")
    before = dict(ops.launch_counts)
    state, log = loop.run(pipeline, args.steps, state=state, start_step=start_step)
    launches = {k: n - before.get(k, 0) for k, n in ops.launch_counts.items()
                if n > before.get(k, 0)}
    log.telemetry.update(probe_steps=probe_steps, start_step=start_step,
                         n_workers=pipeline.n_workers,
                         device_prefetch=pipeline.device_prefetch)
    for s, m, sps, tps, mfu in zip(log.steps, log.metrics, log.samples_per_s,
                                   log.tokens_per_s, log.mfu):
        print(f"  step {s:5d} loss={m['loss']:.4f} xent={m['xent']:.4f} "
              f"acc={m.get('acc', float('nan')):.3f} samples/s={sps:.1f} "
              f"tokens/s={tps:.0f} mfu={mfu:.2e}")
    t = log.telemetry
    print(f"[telemetry] step_ema={t['step_time_ema']*1e3:.1f}ms "
          f"step_p50={t['step_time_p50']*1e3:.1f}ms "
          f"tokens/s={t['tokens_per_s']:.0f} "
          f"host_stall={t['stall_fraction']*100:.1f}% "
          f"data_wait={t['data_wait_s'] / max(t['total_s'], 1e-9) * 100:.1f}% "
          f"device_puts={t['device_puts']} ckpt_saves={t['ckpt_saves']} "
          f"ckpt_host_copy={t['ckpt_host_copy_s']*1e3:.1f}ms "
          f"ckpt_write={t['ckpt_write_s']*1e3:.1f}ms "
          f"grad_sync={t['grad_sync']}/{t['grad_buckets']}bkt/"
          f"{t['grad_comm_bytes']/1e6:.1f}MB")
    n_run = args.steps - start_step
    if runner.scatter is not None:
        print(f"[gradsync] rank={pidx} all_gathers={t['param_all_gathers']} "
              f"reduce_scatters={t['grad_reduce_scatters']} "
              f"all_reduces={t['grad_all_reduces']} "
              f"per_step={t['param_all_gathers'] / max(n_run, 1):g}/"
              f"{t['grad_reduce_scatters'] / max(n_run, 1):g}/"
              f"{t['grad_all_reduces'] / max(n_run, 1):g} "
              f"scatter_buckets={gs['n_scatter_buckets']} psum_buckets={gs['n_psum_buckets']}")
    if runner.sync is not None:
        print(f"[gradsync] rank={pidx} all_reduces={t['grad_all_reduces']} "
              f"per_step={t['grad_all_reduces'] / max(n_run, 1):g} "
              f"hooks_once={t['grad_hooks_once']} "
              f"exposed_sync_p50={t['grad_exposed_sync_p50_s']*1e3:.2f}ms "
              f"bucket_wait_ms={[round(w * 1e3, 3) for w in t['grad_bucket_wait_s']]}")
    if device.type == "cuda":
        held = sum(x.nbytes for x in state["params"].parameters()) + sum(
            x.nbytes for m in ("mu", "nu") for x in state["opt"][m].values())
        print(f"[memory] rank={pidx} state={held / 1e6:.1f}MB peak_allocated="
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f}GiB")
    if launches:
        print(f"[kernels] rank={pidx} steps={args.steps - start_step} "
              f"launches={json.dumps(launches, sort_keys=True)}")
    if args.metrics_jsonl:
        print(f"[metrics] wrote {args.metrics_jsonl}")
    if tracer is not None:
        path = tracer.flush(args.trace_dir)
        print(f"[trace] wrote {path} ({len(tracer)} events, "
              f"{tracer.dropped} dropped) — open in ui.perfetto.dev")
    print("[done]")
    return state, log


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()

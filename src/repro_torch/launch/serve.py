"""Serving launcher: continuous batching through the paged engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
      --paged --batch 4 --prompt-len 32 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --paged

Runs on the card; ``--device cpu`` runs the same path on the CPU with
the kernels' plain versions (``--reduced`` makes that quick).  Weights
are random, drawn from ``--seed``; so are the prompt tokens.  Only the
``--paged`` path is ported (the JAX launcher's static-batch
``ServeEngine`` and ``--trace-dir`` come later).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import default_run_config, get_config, reduced
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.observability.metrics import (DECODE_BUCKETS_MS,
                                               TTFT_BUCKETS_MS,
                                               MetricsRegistry)
from repro_torch.serve.engine import PagedServeEngine


def random_prompts(n: int, lengths: Sequence[int], vocab_size: int,
                   seed: int) -> List[List[int]]:
    """``n`` prompts of the given lengths (cycled), tokens in [4, vocab)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(4, vocab_size, int(lengths[i % len(lengths)])).tolist()
            for i in range(n)]


def build_engine(cfg: ModelConfig, *, device=None, dtype: str = "float32",
                 seed: int = 0, metrics: Optional[MetricsRegistry] = None,
                 **engine_kw) -> PagedServeEngine:
    """A paged engine over a model of ``cfg`` with weights drawn from
    ``seed`` on ``device`` (``None`` = the card)."""
    device = resolve_device(device)
    model = build_model(cfg, seed=seed, dtype=getattr(torch, dtype),
                        device=device)
    run = default_run_config(cfg, ShapeConfig("serve", 0, 0, "decode"),
                             param_dtype=dtype, activation_dtype=dtype)
    return PagedServeEngine(model, run, metrics=metrics, **engine_kw)


def serve(eng: PagedServeEngine, prompts: Sequence[Sequence[int]],
          max_new: int, temperature: float = 0.0) -> Dict[int, List[int]]:
    """Submit every prompt and drive the engine until all have finished."""
    for p in prompts:
        eng.submit(p, max_new)
    return eng.serve(temperature=temperature)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged-KV continuous-batching "
                         "engine (the only path ported so far)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append the serve metrics-registry snapshot "
                         "(TTFT/decode histograms) to this file")
    args = ap.parse_args(argv)
    if not args.paged:
        ap.error("only --paged is ported; the static-batch ServeEngine "
                 "comes later")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    registry = MetricsRegistry()
    eng = build_engine(cfg, device=args.device, dtype=args.dtype,
                       seed=args.seed, metrics=registry)
    prompts = random_prompts(args.batch, [args.prompt_len], cfg.vocab_size,
                             args.seed + 1)
    t0 = time.perf_counter()
    out = serve(eng, prompts, args.max_new, args.temperature)
    dt = time.perf_counter() - t0
    ttft = np.median(eng.samples["ttft_ms"])
    tick = np.median(eng.samples["decode_tick_ms"]) \
        if eng.samples["decode_tick_ms"] else float("nan")
    print(f"[serve] {cfg.name} paged on {eng.device}: {args.batch} requests "
          f"x {args.prompt_len} prompt + {args.max_new} new in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s, "
          f"ttft_p50={ttft:.1f}ms decode_tick_p50={tick:.2f}ms "
          f"ticks={eng.decode_ticks})")
    print({rid: toks[:8] for rid, toks in sorted(out.items())})
    if args.metrics_jsonl:   # latency histograms from the engine's samples
        for key, buckets in (("ttft_ms", TTFT_BUCKETS_MS),
                             ("decode_tick_ms", DECODE_BUCKETS_MS)):
            hist = registry.histogram(f"serve_{key}", buckets)
            for ms in eng.samples[key]:
                hist.observe(ms)
        registry.write_jsonl(args.metrics_jsonl, extra={"final": True})
        print(f"[metrics] wrote {args.metrics_jsonl}")


if __name__ == "__main__":
    main()

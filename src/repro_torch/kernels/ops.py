"""Public kernel ops, dispatched by the device of their tensors.

A CPU tensor goes to the plain version in ``kernels/ref.py``; a CUDA
tensor goes to the hand-written kernel, which launches or raises — there
is no fallback.  ``launch_counts[name]`` counts the kernel launches
(never the plain version's calls), the backward kernels under their own
names (``flash_attention_bwd``, ``fused_xent_bwd``, ``ssd_scan_bwd``).

``flash_attention``, ``xent`` and ``ssd`` are differentiable.  As in
the JAX package the backward recomputes from the saved inputs and never
stores a score or probability matrix: on the CPU it is the autograd of
the plain version run again (the JAX ``_fa_bwd`` / ``_xe_bwd`` /
``_ssd_bwd`` vjp), on the card the backward kernel (flash and xent fed
the row log-sum-exp their forward kernel wrote; ``ssd`` recomputes its
chunk states from x, dt, A, B and C).  ``paged_attention`` serves decode
only and has no backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import launch_counts, reset_launch_counts  # noqa: F401


def _plain_vjp(fn, inputs, grad):
    """The gradient of ``fn(*inputs)`` for ``grad`` (a tuple where ``fn``
    returns one) by the plain version's autograd, recomputing its
    forward."""
    inputs = [x.detach().requires_grad_(True) for x in inputs]
    with torch.enable_grad():
        out = fn(*inputs)
    return torch.autograd.grad(out, inputs, grad)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        train = any(ctx.needs_input_grad[:3])
        if q.is_cuda:
            from repro_torch.kernels.flash_attention import flash_attention_fwd

            if not train:
                return flash_attention_fwd(q, k, v, **ctx.opts)
            o, lse = flash_attention_fwd(q, k, v, return_lse=True, **ctx.opts)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention: no kernel for device {q.device}")
        if train:
            ctx.save_for_backward(q, k, v)
        return kref.flash_attention_ref(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            from repro_torch.kernels.flash_attention import flash_attention_bwd

            q, k, v, o, lse = ctx.saved_tensors
            grads = flash_attention_bwd(q, k, v, o, lse, g.contiguous(), **ctx.opts)
        else:
            grads = _plain_vjp(
                lambda q_, k_, v_: kref.flash_attention_ref(q_, k_, v_, **ctx.opts),
                ctx.saved_tensors, g)
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None, softcap: float = 0.0,
                    scale: Optional[float] = None):
    """q:(B,S,H,D), k:(B,S,Hkv,D), v:(B,S,Hkv,Dv) -> (B,S,H,Dv), Dv = D
    or MLA's (192, 128); see ``kernels/flash_attention.py``."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    window: Optional[int] = None, softcap: float = 0.0,
                    scale: Optional[float] = None):
    """q:(B,H,D) against (NP,P,Hkv,D) pools via (B,maxp) block tables;
    see ``kernels/paged_attention.py``."""
    if q.is_cuda:
        from repro_torch.kernels.paged_attention import paged_attention_fwd

        return paged_attention_fwd(q, k_pages, v_pages, block_tables,
                                   seq_lens, window=window, softcap=softcap,
                                   scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    return kref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                    seq_lens, window=window, softcap=softcap,
                                    scale=scale)


class _Xent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        if logits.is_cuda:
            from repro_torch.kernels.fused_xent import fused_xent_fwd

            nll, lse = fused_xent_fwd(logits, labels)
            ctx.save_for_backward(logits, labels, lse)
            return nll
        if logits.device.type != "cpu":
            raise ValueError(f"xent: no kernel for device {logits.device}")
        ctx.save_for_backward(logits, labels)
        return kref.xent_ref(logits, labels)

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            from repro_torch.kernels.fused_xent import fused_xent_bwd

            logits, labels, lse = ctx.saved_tensors
            return fused_xent_bwd(logits, labels, lse, g), None
        logits, labels = ctx.saved_tensors
        (dlogits,) = _plain_vjp(lambda x: kref.xent_ref(x, labels), [logits], g)
        return dlogits, None


def xent(logits, labels):
    """Per-token nll of logits:(T,V) f32/bf16 at labels:(T,) -> (T,) f32;
    see ``kernels/fused_xent.py``."""
    return _Xent.apply(logits, labels)


class _Ssd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.chunk = chunk
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"ssd: no kernel for device {x.device}")
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, dt, A, B, C)
        if x.is_cuda:
            from repro_torch.kernels.ssd_scan import ssd_scan_fwd

            return ssd_scan_fwd(x, dt, A, B, C, chunk)
        return kref.ssd_ref(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        if gy.is_cuda:
            from repro_torch.kernels.ssd_scan import ssd_scan_bwd

            grads = ssd_scan_bwd(*ctx.saved_tensors, gy, gstate, ctx.chunk)
        else:
            grads = _plain_vjp(lambda *a: kref.ssd_ref(*a, chunk=ctx.chunk),
                               ctx.saved_tensors, (gy, gstate))
        return (*grads, None)


def ssd(x, dt, A, B, C, chunk: int = 256):
    """Mamba2 SSD chunked scan: x:(B,S,H,P), dt:(B,S,H), A:(H,),
    B,C:(B,S,G,N) -> (y:(B,S,H,P) in x's dtype, final state (B,H,N,P)
    f32); see ``kernels/ssd_scan.py``."""
    return _Ssd.apply(x, dt, A, B, C, chunk)

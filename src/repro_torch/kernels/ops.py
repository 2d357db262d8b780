"""Public kernel ops, dispatched by the device of their tensors.

A CPU tensor goes to the plain version in ``kernels/ref.py``; a CUDA
tensor goes to the hand-written kernel, which launches or raises — there
is no fallback.  ``launch_counts[name]`` counts the kernel launches
(never the plain version's calls).  Serving never differentiates through
these ops; the training slice adds their backward.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import launch_counts, reset_launch_counts  # noqa: F401


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None, softcap: float = 0.0,
                    scale: Optional[float] = None):
    """q:(B,S,H,D), k/v:(B,S,Hkv,D) -> (B,S,H,D); see
    ``kernels/flash_attention.py``."""
    if q.is_cuda:
        from repro_torch.kernels.flash_attention import flash_attention_fwd

        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return kref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale)


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

"""Masked-language-modeling objective (the paper's pretraining task).

15% of tokens are selected; of those 80% become [MASK], 10% a random token,
10% unchanged (BERT recipe).  Loss is cross-entropy on the selected
positions only.  The JAX package draws the masks from ``jax.random``;
here an explicit ``torch.Generator`` does, so the two packages agree on
the recipe and not on the bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

MASK_RATE = 0.15


def mask_tokens(gen: torch.Generator, tokens, vocab_size: int, mask_id: int,
                mask_rate: float = MASK_RATE, special_boundary: int = 4):
    """Returns (inputs, labels, loss_mask f32).  Token ids <
    special_boundary are never masked (pad/cls/sep/mask specials).  The
    draws happen on ``gen``'s device."""
    dev = gen.device
    shape = tokens.shape
    maskable = tokens >= special_boundary
    u = torch.rand(shape, generator=gen, device=dev).to(tokens.device)
    r = torch.rand(shape, generator=gen, device=dev).to(tokens.device)
    rand_tok = torch.randint(special_boundary, vocab_size, shape, generator=gen,
                             device=dev).to(tokens.device, tokens.dtype)
    sel = (u < mask_rate) & maskable
    inputs = torch.where(sel & (r < 0.8), torch.full_like(tokens, mask_id), tokens)
    inputs = torch.where(sel & (r >= 0.8) & (r < 0.9), rand_tok, inputs)
    return inputs, tokens, sel.float()


def _nll(logits, labels):
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(lp, labels.long()[..., None], dim=-1)[..., 0]


def mlm_loss(logits, labels, loss_mask) -> Tuple[torch.Tensor, dict]:
    nll = _nll(logits, labels)
    denom = loss_mask.sum().clamp(min=1.0)
    loss = (nll * loss_mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * loss_mask).sum() / denom
    return loss, {"mlm_loss": loss, "mlm_acc": acc, "masked_tokens": loss_mask.sum()}


def lm_loss(logits, labels, loss_mask=None):
    """Next-token cross entropy for decoder-only LMs; labels are already
    shifted by the data pipeline (labels[t] = tokens[t+1])."""
    nll = _nll(logits, labels)
    if loss_mask is None:
        loss_mask = torch.ones_like(nll)
    denom = loss_mask.sum().clamp(min=1.0)
    loss = (nll * loss_mask).sum() / denom
    return loss, {"lm_loss": loss, "tokens": denom}

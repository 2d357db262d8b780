"""KV-cache leaf walk.

Every cache tree has the structure ``{"groups": [[{part: {leaf:
tensor}}]]}`` with leaves stacked over a leading ``layers`` axis.
:func:`walk_cache` answers once whether a leaf is a growing sequence
buffer or a fixed-size one, so the pool construction and the prefill
commit of ``serve/paged_cache.py`` cannot drift apart:

* *sequence* leaves (``k``/``v``/``ckv``/``kr`` of a non-windowed
  mixer): axis 2 (after layers, batch) is the sequence;
* *fixed* leaves: sliding-window ring buffers (the ``pos`` key marks
  them), SSM conv/state buffers, and cross-attention caches.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# cache leaves whose axis 2 (after the stacked layers axis) is the sequence:
_SEQ_LEAVES = ("k", "v", "ckv", "kr")


def is_fixed_part(part: str, sub) -> bool:
    """True if every leaf of this cache part is fixed-size (ring buffer,
    SSM state, cross-attn)."""
    return part == "cross" or (part == "mixer" and "pos" in sub)


def walk_cache(cache, cfg: ModelConfig, seq_fn, fixed_fn):
    """Rebuild a cache tree, applying ``seq_fn(name, leaf, spec)`` to the
    growing sequence leaves and ``fixed_fn(name, leaf, spec)`` to the
    fixed-size ones.  Leaves are visited in sorted key order, so two walks
    over trees of one structure pair their leaves 1:1."""
    new_groups = []
    for gi, g in enumerate(cfg.schedule):
        layers = []
        for pi, spec in enumerate(g.pattern):
            layer_cache = cache["groups"][gi][pi]
            out = {}
            for part, sub in sorted(layer_cache.items()):
                fixed = is_fixed_part(part, sub)
                new = {}
                for k, v in sorted(sub.items()):
                    if not fixed and part == "mixer" and k in _SEQ_LEAVES:
                        new[k] = seq_fn(k, v, spec)
                    else:
                        new[k] = fixed_fn(k, v, spec)
                out[part] = new
            layers.append(out)
        new_groups.append(layers)
    return {"groups": new_groups}

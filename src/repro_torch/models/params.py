"""Parameter-spec trees and the module that holds them.

Each module declares its parameters once as a tree of :class:`ParamSpec`
(shape + logical axis names + initializer), exactly as in the JAX
package.  :func:`init_params` draws a tree of tensors from a
``torch.Generator``; :class:`ParamTree` registers such a tree as nested
modules, so that ``state_dict`` keys are the JAX leaf paths
(``groups.0.0.mixer.wq``, the stacked ``layers`` axis kept);
:func:`from_jax_params` turns a JAX parameter tree, with numpy leaves,
into that ``state_dict``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 0.0                # 0 => 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_specs(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree node: {type(tree)}")


def flatten_tree(tree, prefix: str = "") -> Dict[str, object]:
    """``{"a.b.0.c": leaf}`` in the JAX pytree order (dict keys sorted,
    lists in order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[-1]
    if len(shape) == 2:
        return shape[0]
    # stacked / 3D+: the product of all but the last axis, divided by a
    # leading ``layers`` stack axis that initializers must ignore
    return max(1, int(np.prod(shape[:-1])) // shape[0])


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("ssm_a", "ssm_dt"):
        lo, hi = (1.0, 16.0) if spec.init == "ssm_a" else (1e-3, 1e-1)
        u = torch.empty(spec.shape, dtype=torch.float32, device=device)
        u.uniform_(lo, hi, generator=gen)
        # A_log = log(u); dt bias = inverse softplus of u
        out = torch.log(u) if spec.init == "ssm_a" else \
            u + torch.log(-torch.expm1(-u))
        return out.to(dtype)
    scale = spec.scale if spec.scale else 1.0 / np.sqrt(_fan_in(spec.shape))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def init_params(spec_tree, gen: torch.Generator, dtype=torch.float32,
                device=None):
    """Tensor tree for ``spec_tree``; leaves are drawn from ``gen`` in the
    flattened (sorted-key) order, so a seed fixes every leaf."""
    flat = flatten_tree(spec_tree)
    vals = {k: _init_leaf(s, gen, dtype, device) for k, s in flat.items()}
    return tree_map_paths(lambda path, _: vals[path], spec_tree)


def tree_map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: tree_map_paths(fn, v, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_paths(fn, v, f"{prefix}{i}.")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def stack_specs(spec_tree, repeats: int):
    """Prepend a ``layers`` stack axis of size ``repeats`` to every leaf."""
    return tree_map_specs(
        lambda s: dataclasses.replace(
            s, shape=(repeats, *s.shape), axes=("layers", *s.axes)
        ),
        spec_tree,
    )


class ParamTree(nn.Module):
    """A dict node of a parameter tree: leaves are parameters (frozen
    until ``train.train_step.init_state`` makes them trainable), dict
    children are ``ParamTree``s and list children ``ModuleList``s.
    ``tree["name"]`` reads a child, as the JAX code reads its dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            self.add_child(k, v)

    def add_child(self, name: str, v) -> None:
        if isinstance(v, dict):
            self.add_module(name, ParamTree(v))
        elif isinstance(v, (list, tuple)):
            self.add_module(name, _module_list(v))
        else:
            self.register_parameter(name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def _module_list(items) -> nn.ModuleList:
    out = nn.ModuleList()
    for v in items:
        if isinstance(v, dict):
            out.append(ParamTree(v))
        elif isinstance(v, (list, tuple)):
            out.append(_module_list(v))
        else:
            raise TypeError("a list in a parameter tree holds dicts or lists")
    return out


def from_jax_params(np_tree, spec_tree) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX parameter tree whose leaves are
    numpy arrays, leaf for leaf.  Raises on a missing or extra leaf, or a
    shape that differs from ``spec_tree``'s."""
    got = flatten_tree(np_tree)
    want = flatten_tree(spec_tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"JAX params do not match the specs: missing "
                       f"{missing}, extra {extra}")
    out = {}
    for k, spec in want.items():
        a = np.asarray(got[k])
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{k}: JAX shape {a.shape} != spec shape "
                             f"{spec.shape}")
        if a.dtype.name == "bfloat16":      # ml_dtypes: numpy has no bf16
            out[k] = torch.from_numpy(a.astype(np.float32)).bfloat16()
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(a).copy())
    return out

"""Seeded weights drawn on the device, by the rules a configuration file
states under ``init``.

One generator on the device, seeded with the run's seed, draws every leaf
in name order, each in one call, in the dtype the model is served or
trained in. The same seed gives the same weights, so the reference can
draw them again once the program has let go of its own.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Shapes = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def _rule(init: dict, name: str) -> dict:
    leaf = name.rsplit(".", 1)[-1]
    if leaf not in init:
        raise KeyError(f"the configuration states no init rule for {name}")
    return init[leaf]


def draw(shapes: Shapes, init: dict, seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in sorted(shapes):
        shape, dtype = shapes[name]
        rule = _rule(init, name)
        body = shape[1:] if name.startswith("stack.") else shape
        if "const" in rule:
            t = torch.full(shape, rule["const"], dtype=dtype, device=device)
        elif "log_arange_last" in rule:
            n = shape[-1]
            t = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=device)).expand(shape)
            t = t.to(dtype).contiguous()
        elif "inv_softplus_log_uniform" in rule:
            lo, hi = rule["inv_softplus_log_uniform"]
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
            t = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        else:
            if "std" in rule:
                std = rule["std"]
            else:
                fan_in = math.prod(body[a] for a in rule["fan_in_axes"])
                std = 1.0 / math.sqrt(fan_in)
            t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            t.mul_(std)
        out[name] = t
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a.b.c": t} -> {"a": {"b": {"c": t}}}."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def shapes_of(tree: dict) -> Shapes:
    return {n: (tuple(t.shape), t.dtype) for n, t in flatten(tree).items()}


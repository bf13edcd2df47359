"""Architecture config registry.

``get_config(name)`` resolves an arch id (e.g. ``--arch gemma3-12b``) to its
``ArchConfig``.  ``reduced(cfg)`` derives the small same-family config used by
per-arch CPU smoke tests (full configs are only ever lowered via the dry-run).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ArchConfig, EncoderConfig, MoEConfig,
                                ShapeConfig, SHAPE_GRID, SHAPES, SSMConfig,
                                XLSTMConfig, shape_applicable)

from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from repro_torch.configs.internlm2_1_8b import CONFIG as INTERNLM2_1_8B
from repro_torch.configs.granite_8b import CONFIG as GRANITE_8B
from repro_torch.configs.nemotron_4_340b import CONFIG as NEMOTRON_4_340B
from repro_torch.configs.gemma3_12b import CONFIG as GEMMA3_12B
from repro_torch.configs.xlstm_125m import CONFIG as XLSTM_125M
from repro_torch.configs.internvl2_2b import CONFIG as INTERNVL2_2B
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as LLAMA4_SCOUT
from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA_V0_1_52B
from repro_torch.configs.repro_100m import CONFIG as REPRO_100M

ARCH_REGISTRY = {
    c.name: c for c in (
        SEAMLESS_M4T_MEDIUM,
        INTERNLM2_1_8B,
        GRANITE_8B,
        NEMOTRON_4_340B,
        GEMMA3_12B,
        XLSTM_125M,
        INTERNVL2_2B,
        LLAMA4_MAVERICK,
        LLAMA4_SCOUT,
        JAMBA_V0_1_52B,
        REPRO_100M,
    )
}

ASSIGNED_ARCHS = tuple(n for n in ARCH_REGISTRY if n != "repro-100m")


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.attn_every == 1 else cfg.attn_every),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
    )
    if cfg.attn_every > 1:
        changes["n_layers"] = cfg.attn_every          # one full hybrid group
        changes["attn_every"] = cfg.attn_every
    if cfg.attn_pattern == "local_global":
        changes["n_layers"] = cfg.local_global_ratio + 1  # one local:global group
        changes["local_window"] = 8
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4), d_ff=256)
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(
            cfg.encoder, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=256)
    if cfg.frontend is not None:
        changes["frontend_len"] = 8
    return dataclasses.replace(cfg, **changes)


__all__ = [
    "ArchConfig", "EncoderConfig", "MoEConfig", "SSMConfig", "XLSTMConfig",
    "ShapeConfig", "SHAPE_GRID", "SHAPES", "shape_applicable",
    "ARCH_REGISTRY", "ASSIGNED_ARCHS", "get_config", "reduced",
]

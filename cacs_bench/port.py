"""What the harness takes from the program under test (``repro_torch``):
the model configuration built from a configuration file's ``port``
numbers, the shapes of its parameters, and its CUDA kernels built before
a window opens."""
from __future__ import annotations

from typing import Any, Dict


def arch_config(port: Dict[str, Any]):
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
    kw = dict(port)
    if "moe" in kw:
        kw["moe"] = MoEConfig(**kw["moe"])
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ArchConfig(**kw)


def param_shapes(cfg) -> Dict[str, Any]:
    """{"embed.embedding": (shape, dtype), ...} with nothing allocated."""
    from repro_torch.models.model import build_model
    from cacs_bench.weights import shapes_of
    return shapes_of(build_model(cfg).abstract_params())


def build_kernels(device, names) -> None:
    """Build (or find built) the port's kernels and load them, so that no
    window compiles. On the CPU the port runs their plain versions."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import build
    for name in names:
        build.build(name)
        build.load(name)

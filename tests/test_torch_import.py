"""The port stands alone: importing any module of ``repro_torch``, or
``chip_smoke.py``, loads neither JAX, ``ml_dtypes`` nor the reference
package ``repro`` (the machine with the card has none of them)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_CHECK = """
import sys
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
assert not bad, bad
print("clean", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code) + _CHECK],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=str(ROOT))
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return r.stdout


def test_every_port_module_imports_without_jax_or_repro():
    out = _run("""
        import pkgutil
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            __import__(m.name)
    """)
    n = int(out.split()[-1])
    assert n >= 84, out                  # every subpackage was walked


@pytest.mark.parametrize("entry", ["chip_smoke", "repro_torch.train",
                                   "repro_torch.ckpt", "repro_torch.serve",
                                   "repro_torch.launch.serve",
                                   "repro_torch.kernels.ops",
                                   "repro_torch.core", "repro_torch.clusters",
                                   "repro_torch.launch.train",
                                   "repro_torch.models.moe",
                                   "repro_torch.models.ssm",
                                   "repro_torch.models.xlstm",
                                   "repro_torch.launch.mesh",
                                   "repro_torch.train.grad_compress",
                                   "repro_torch.sharding.specs"])
def test_entry_point_imports_without_jax_or_repro(entry):
    _run(f"""
        import importlib, sys
        sys.path.insert(0, ".")
        importlib.import_module({entry!r})
    """)

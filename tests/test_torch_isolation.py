"""The port stands alone: no JAX and nothing of the JAX package in it, and
no silent fallback from CUDA to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)",
                       re.MULTILINE)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_no_source_line_imports_jax_or_the_jax_package():
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in _sources()
                 for m in FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders
    assert len(_sources()) >= 20


def test_entry_points_raise_on_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve
    from repro_torch.launch.serve import ServeConfig, serve_config
    from repro_torch.models import build_model

    cfg = get_arch("yi-6b").reduced()
    model = build_model(cfg)
    for call in (lambda: resolve("cuda"),
                 lambda: model.init(0),
                 lambda: model.init(0, "cuda"),
                 lambda: model.init_caches(2, 8),
                 lambda: params_from_jax({}, cfg),
                 lambda: serve_config(ServeConfig()),
                 lambda: serve_config(ServeConfig(device="cuda"))):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_cuda_kernel_sources_ship_with_the_package():
    for name in ("flash_attention.cu", "paged_attention.cu", "common.cuh"):
        assert (PORT / "kernels" / "csrc" / name).is_file()
    text = (ROOT / "pyproject.toml").read_text()
    assert 'repro_torch = ["kernels/csrc/*.cu", "kernels/csrc/*.cuh"]' in text

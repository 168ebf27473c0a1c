"""The port stands alone: repro_torch and chip_smoke.py import neither JAX
nor anything of the reference package, and the port's entry points refuse
to fall back to the CPU when CUDA is absent."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm
from repro_torch.runtime.serve_loop import ServeConfig, serve

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
_FORBIDDEN_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?!\w)", re.M)

_SCRIPT = """
import importlib, json, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({{"modules": names, "bad": bad}}))
"""


def test_port_modules_import_no_jax_and_no_reference(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT))],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.runtime.serve_loop" in res["modules"]
    assert "repro_torch.kernels.flash_attention.ops" in res["modules"]
    assert res["bad"] == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_source_has_no_jax_or_reference_import(path):
    assert _FORBIDDEN_IMPORT.findall(path.read_text()) == []


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b", smoke=True)
    params = lm.init(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, ShapeSpec("t", 8, 1, "prefill"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(cfg, params, batch, ServeConfig(max_new_tokens=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--smoke"])
    res = serve_cli.main(["--smoke", "--device", "cpu", "--seq", "8",
                          "--batch", "1", "--new-tokens", "2"])
    assert res["tokens"].shape == (1, 2)

"""facet_tpu_torch must run where jax is not installed.

A subprocess refuses every import of jax, jaxlib, flax and optax, imports
facet_tpu_torch and every module under it, and runs a 2-image
``--pass quality`` scan on the CPU. The files the port loads through
``facet_tpu_torch._host`` must have no jax import in their own source, and
no file of the package may import jax at all.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax")

SCRIPT = r'''
import importlib, importlib.abc, json, os, pkgutil, sqlite3, sys

BLOCKED = {"jax", "jaxlib", "flax", "optax"}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: the port must not need it")
        return None

sys.meta_path.insert(0, Refuse())

import facet_tpu_torch
names = []
for info in pkgutil.walk_packages(facet_tpu_torch.__path__, "facet_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)

import numpy as np
from PIL import Image
from facet_tpu.config.default_config import write_default_config

os.makedirs("photos")
rng = np.random.default_rng(0)
for i, shape in enumerate([(48, 64, 3), (51, 37, 3)]):
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(f"photos/p{i}.jpg")
write_default_config("cfg.json")
cfg = json.load(open("cfg.json"))
cfg["models"]["clip"]["architecture"] = {"image_size": 28, "patch_size": 14,
                                         "width": 32, "layers": 1, "heads": 2,
                                         "projection_dim": 768}
json.dump(cfg, open("cfg.json", "w"))

# the fast tier's TOPIQ at 128 px instead of 256: its C2 level (1024 queries
# over 256 keys) still passes the kernel's gate, at a quarter of the work
from facet_tpu_torch.models import topiq
topiq.FAST_TIER_INPUT_SIZE = 128

from facet_tpu_torch.__main__ import main
rc = main(["photos", "--pass", "quality", "--db", "scan.db", "--config", "cfg.json",
           "--speed-tier", "fast"])
rows = sqlite3.connect("scan.db").execute(
    "SELECT topiq_score, phash, raw_color_entropy, aggregate FROM photos").fetchall()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("RESULT " + json.dumps({"rc": rc, "modules": names, "rows": rows, "leaked": leaked}))
'''


def test_port_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("FACET_PLATFORM", "JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    result = json.loads(line[len("RESULT "):])
    assert result["rc"] == 0
    assert result["leaked"] == []
    assert "facet_tpu_torch.ops.entropy" in result["modules"]
    assert "facet_tpu_torch.__main__" in result["modules"]
    assert len(result["rows"]) == 2
    assert all(v is not None for row in result["rows"] for v in row)


def _imported_roots(path):
    tree = ast.parse(Path(path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_host_files_import_no_jax():
    from facet_tpu_torch import _host

    for name in _host.ALLOWED:
        roots = _imported_roots(_host.source_path(name))
        assert not roots & set(BLOCKED), (name, roots)
        # nor anything of facet_tpu, whose package __init__s pull jax in
        assert "facet_tpu" not in roots, (name, roots)


def test_package_source_imports_no_jax():
    for path in (REPO / "facet_tpu_torch").rglob("*.py"):
        assert not _imported_roots(path) & set(BLOCKED), path
    # the smoke test drives the port alone: nothing of jax or facet_tpu
    assert not _imported_roots(REPO / "chip_smoke.py") & {*BLOCKED, "facet_tpu"}

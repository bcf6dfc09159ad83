"""facet_tpu_torch must stand alone: no jax, and nothing of facet_tpu.

A subprocess refuses every import of jax, jaxlib, flax, optax and
facet_tpu, imports facet_tpu_torch and every module under it (the Qwen
tagger's included), and runs one 2-image scan on the CPU (``--device
cpu``): the default multi-pass scan under the "24gb" profile with nothing
installed, so that the tagger chain walks to CLIP tags beside CLIP,
TOPIQ, SAMP-Net and the faces member (in the fast tier, with TOPIQ at 128
px and SCRFD on a 160 px canvas). No file of the package, and not
chip_smoke.py, may import any of those roots or name the facet_tpu
directory. Without a card, and without an explicit request for the CPU,
the CLI and ModelManager fail.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "facet_tpu")

SCRIPT = r'''
import importlib, importlib.abc, json, os, pkgutil, sqlite3, sys

BLOCKED = {"jax", "jaxlib", "flax", "optax", "facet_tpu"}

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
from facet_tpu_torch.config.default_config import write_default_config

os.makedirs("photos")
rng = np.random.default_rng(0)
for i, shape in enumerate([(48, 64, 3), (51, 37, 3)]):
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(f"photos/p{i}.jpg")
write_default_config("cfg.json")
cfg = json.load(open("cfg.json"))
cfg["models"]["clip"]["architecture"] = {"image_size": 28, "patch_size": 14,
                                         "width": 32, "layers": 1, "heads": 2,
                                         "projection_dim": 768}
cfg["models"]["vram_profile"] = "24gb"
json.dump(cfg, open("cfg24.json", "w"))

# TOPIQ at 128 px instead of the fast tier's 256: its C2 level (1024
# queries over 256 keys) still passes the kernel's gate, at a fraction of
# the work; SCRFD on a 160 px canvas instead of the fast tier's 448
import functools
from facet_tpu_torch.models import topiq
topiq.FAST_TIER_INPUT_SIZE = 128
topiq.TOPIQConfig = functools.partial(topiq.TOPIQConfig, input_size=128)
from facet_tpu_torch.models import face_pipeline
face_pipeline.FAST_TIER_DET_SIZE = 160

import contextlib, io
from facet_tpu_torch.__main__ import main
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    rc = main(["photos", "--db", "scan.db", "--config", "cfg24.json", "--speed-tier", "fast",
               "--device", "cpu"])
rows = sqlite3.connect("scan.db").execute(
    "SELECT topiq_score, phash, raw_color_entropy, aggregate, composition_pattern,"
    " face_count, clip_embedding IS NOT NULL FROM photos ORDER BY path").fetchall()
chain = [ln.split(":")[0].strip() for ln in printed.getvalue().splitlines()
         if "unavailable" in ln]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("RESULT " + json.dumps({"rc": rc, "modules": names, "rows": rows, "leaked": leaked,
                              "chain": chain}))
'''


def test_port_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("FACET_PLATFORM", "JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    # the scans' models are tiny: two threads, so that the subprocess does
    # not contend with the test workers for every core
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    result = json.loads(line[len("RESULT "):])
    assert result["rc"] == 0
    assert result["leaked"] == []
    for module in ("ops.entropy", "ops.fused_stats", "models.face_pipeline",
                   "models.qwen_text", "models.qwen_vision", "models.vlm_tagger", "__main__"):
        assert f"facet_tpu_torch.{module}" in result["modules"]
    # the 24gb profile's tagger chain walked to CLIP tags, and the scan ran
    # TOPIQ, SAMP-Net and the faces member (whose fallback SCRFD finds no
    # face: its reg scales are zero) beside CLIP
    assert result["chain"] == ["pass vlm_tagger", "pass qwen3_vl_tagger", "pass ram_tagger"]
    assert len(result["rows"]) == 2
    assert all(v is not None for row in result["rows"] for v in row)
    assert [tuple(r[5:]) for r in result["rows"]] == [(0, 1), (0, 1)]


def _imported_roots(path):
    tree = ast.parse(Path(path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def _names_facet_tpu_dir(path):
    """True when a string in the file's code (docstrings aside) is exactly
    the facet_tpu directory's name, as a path built to it would hold."""
    tree = ast.parse(Path(path).read_text())
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)}
    return any(isinstance(node, ast.Constant) and node.value == "facet_tpu"
               and id(node) not in docstrings for node in ast.walk(tree))


def test_package_source_imports_no_jax():
    files = [*(REPO / "facet_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    for path in files:
        assert not _imported_roots(path) & set(BLOCKED), path
        assert not _names_facet_tpu_dir(path), path
    assert not (REPO / "facet_tpu_torch" / "_host.py").exists()


NO_CARD = r'''
import json, os, sys
from facet_tpu_torch.__main__ import main
from facet_tpu_torch.models.model_manager import ModelManager

os.makedirs("photos")
rc = main(["photos", "--pass", "quality", "--db", "x.db", "--config", "cfg.json"])
try:
    ModelManager()
    manager = "no error"
except RuntimeError as exc:
    manager = str(exc)
print("RESULT " + json.dumps({"rc": rc, "manager": manager,
                              "cpu": str(ModelManager(device="cpu").device)}))
'''


def test_no_card_is_an_error_unless_cpu_is_asked_for(tmp_path):
    """Without a usable card the CLI exits non-zero and ModelManager raises,
    each naming --device cpu; asking for the CPU works."""
    env = {k: v for k, v in os.environ.items() if k != "FACET_PLATFORM"}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", NO_CARD], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    result = json.loads(line[len("RESULT "):])
    assert result["rc"] == 1
    assert "no usable CUDA card" in proc.stderr and "--device cpu" in proc.stderr
    assert "no usable CUDA card" in result["manager"]
    assert "device='cpu'" in result["manager"]
    assert result["cpu"] == "cpu"
    assert not (tmp_path / "x.db").exists()

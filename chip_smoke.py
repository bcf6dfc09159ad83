"""Smoke test of the PyTorch/CUDA port (facet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. device: CUDA must be present; print the card's name and power limit and
   which optional host packages import;
2. build: compile every kernel from facet_tpu_torch/csrc;
3. kernels against their plain PyTorch twins on the card, at the main
   path's shapes (exact histograms, entropy within 1e-5, attention within
   ATTN_TOL and ATTN_REL_RMS_TOL), with median times of kernel and twin
   from CUDA events;
4. the slice: ``python -m facet_tpu_torch <dir> --pass quality`` in-process
   over synthetic photos at full width (ViT-L/14 at 224 in bf16 with the
   aesthetic head, TOPIQ at 384 in f32), then every row is checked, both
   kernels must have launched during the scan, and TOPIQ must have run
   with TF32 off although the process keeps torch's defaults.

The second-to-last line is the kernel report, a JSON object; the last line
is {"ok": true, "device": {...}}.
"""

import importlib.util
import json
import os
import sqlite3
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from facet_tpu_torch.ops import attention, cuda_build, entropy
from facet_tpu_torch.ops.colorspace import rgb_to_hsv

# Kernel 2 against its twin, two limits. The two-pass design rounds p to
# bf16 at the same point as the twin; what remains is f32 summation order,
# which now and then flips the bf16 rounding of one p. A flip of a large p
# (~0.02 at 2304 keys) times a large v (~4) moves one output by ~4e-4, so
# the largest error says little about the rounding points: ATTN_TOL, half
# the 2e-3 bound tests/test_pallas_attn.py pins for the TPU kernel, only
# catches gross faults. The error's RMS relative to the output's RMS sees
# every element: about 2.5e-5 for a kernel with the twin's rounding points
# and about 1.7e-3 for one that leaves p unrounded (a float64 emulation on
# the CPU at (4, 4, 9216, 2304, 64)); ATTN_REL_RMS_TOL sits between.
ATTN_TOL = 1e-3
ATTN_REL_RMS_TOL = 3e-4
ENTROPY_TOL = 1e-5
SCAN_SHAPES = ((1024, 1536), (768, 1024))
SCAN_COUNTS = (24, 8)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def synthetic_photos(n, h, w, seed):
    """Smooth colour fields with noise: photo-like hue/sat histograms."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = rng.uniform(0, 255, 3)
        gx, gy = rng.uniform(-0.15, 0.15, (2, 3))
        img = (base[None, None, :] + gx * xx[..., None] + gy * yy[..., None]
               + 40 * np.sin(xx[..., None] / rng.uniform(20, 200) + i)
               + rng.normal(0, 12, (h, w, 3)))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


# ------------------------------------------------------------------ phases


def phase_device():
    if not torch.cuda.is_available():
        phase("device", "torch.cuda.is_available() is false: this smoke test "
                        "needs an NVIDIA GPU")
        sys.exit(1)
    line = gpu_line()
    phase("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
                    f" | nvidia-smi: {line} | torch {torch.__version__}"
                    f" cuda {torch.version.cuda}")
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("PIL", "cv2", "psutil", "jax")}
    phase("device", f"host packages importable: {found} (jax is not used)")
    return line


def phase_build():
    t0 = time.time()
    cuda_build.library()
    info = cuda_build.build_info
    phase("build", f"{info['path']} built in {info['seconds']:.1f} s "
                   f"({time.time() - t0:.1f} s with load)")
    for ln in info["log"].splitlines():
        if "registers" in ln or "spill" in ln or "smem" in ln:
            phase("build", ln.strip())


def check_entropy(gpu):
    """Kernel 1 vs its twin: the scan's own batches (the reported time is
    the first), the fast tier's stride 4 and an odd h*w; exact histograms."""
    report = {"max_abs_err": 0.0}
    cases = [(n, h, w, 1) for (h, w), n in zip(SCAN_SHAPES, SCAN_COUNTS)]
    cases += [(16, 1024, 1536, 1), (16, 1024, 1536, 4), (3, 37, 53, 1),
              (3, 37, 53, 4)]
    for b, h, w, stride in cases:
        imgs = np.stack(synthetic_photos(b, h, w, seed=h + stride))
        rgb = torch.from_numpy(imgs).cuda()
        hh, ss, _ = rgb_to_hsv(rgb)
        hue = hh.reshape(b, -1).contiguous()
        sat = ss.reshape(b, -1).contiguous()
        got, hist = entropy.hs_entropy_with_histogram(hue, sat, stride)
        want = entropy.hs_entropy_plain(hue, sat, stride)
        want_hist = entropy.hs_histogram_plain(hue, sat, stride)
        torch.cuda.synchronize()
        if not torch.equal(hist, want_hist):
            raise AssertionError(f"entropy histogram differs at {(b, h, w, stride)}")
        err = float((got - want).abs().max())
        if err > ENTROPY_TOL:
            raise AssertionError(f"entropy err {err} > {ENTROPY_TOL} at "
                                 f"{(b, h, w, stride)}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: entropy.hs_entropy(hue, sat, stride))
        plain_ms = cuda_median_ms(lambda: entropy.hs_entropy_plain(hue, sat, stride))
        phase("kernels", f"hs_entropy B={b} {h}x{w} stride={stride}: histogram "
                         f"exact, max|d entropy|={err:.3g}, kernel {ms:.3f} ms, "
                         f"twin {plain_ms:.3f} ms ({gpu})")
        report.setdefault("ms", ms)
        report.setdefault("plain_ms", plain_ms)
    return report


def attention_errors(got, want):
    """(max |got - want|, RMS of got - want over the RMS of want)."""
    diff = (got - want).double()
    return (float(diff.abs().max()),
            float(diff.pow(2).mean().sqrt() / want.double().pow(2).mean().sqrt()))


def check_attention(gpu):
    """Kernel 2 vs its twin: TOPIQ's C2 level at 384 px for the scan's own
    batches (the reported time is the first), then batch 4 at 384 px and at
    the fast tier's 256 px."""
    report = {"max_abs_err": 0.0}
    cases = [(n, 4, 9216, 2304) for n in SCAN_COUNTS]
    cases += [(4, 4, 9216, 2304), (4, 4, 4096, 1024)]
    for b, h, nq, nk in cases:
        g = torch.Generator(device="cuda").manual_seed(nq)
        q = torch.randn((b, h, nq, 64), generator=g, device="cuda") / 8.0
        k = torch.randn((b, h, nk, 64), generator=g, device="cuda")
        v = torch.randn((b, h, nk, 64), generator=g, device="cuda")
        got = attention.cross_attention(q, k, v)
        want = attention.cross_attention_plain(q, k, v)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("cross_attention produced non-finite values")
        err, rel_rms = attention_errors(got, want)
        if err > ATTN_TOL or rel_rms > ATTN_REL_RMS_TOL:
            raise AssertionError(
                f"attention max|d| {err} (tol {ATTN_TOL}), relative RMS "
                f"{rel_rms} (tol {ATTN_REL_RMS_TOL}) at {(b, h, nq, nk)}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: attention.cross_attention(q, k, v))
        plain_ms = cuda_median_ms(lambda: attention.cross_attention_plain(q, k, v))
        phase("kernels", f"cross_attention ({b},{h},{nq},{nk},64): "
                         f"max|d|={err:.3g} (tol {ATTN_TOL}), relative RMS "
                         f"{rel_rms:.3g} (tol {ATTN_REL_RMS_TOL}), kernel "
                         f"{ms:.3f} ms, twin {plain_ms:.3f} ms ({gpu})")
        report.setdefault("ms", ms)
        report.setdefault("plain_ms", plain_ms)
        del q, k, v, got, want
    return report


def phase_kernels(gpu):
    report = {"hs_entropy": check_entropy(gpu),
              "cross_attention": check_attention(gpu)}
    torch.cuda.empty_cache()       # the rider sizes its slices from free memory
    return report


def write_photos(directory):
    from PIL import Image

    paths = []
    for (h, w), count in zip(SCAN_SHAPES, SCAN_COUNTS):
        for i, img in enumerate(synthetic_photos(count, h, w, seed=h * 7)):
            path = os.path.join(directory, f"photo_{h}x{w}_{i:02d}.jpg")
            Image.fromarray(img).save(path, quality=92)
            paths.append(path)
    return paths


def phase_scan(gpu):
    from facet_tpu_torch.__main__ import main as cli_main
    from facet_tpu_torch.models.topiq import TOPIQNet

    def tf32_flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    phase("scan", f"process TF32 flags (cudnn, matmul), torch's defaults: "
                  f"{tf32_flags()}")
    in_topiq = []     # the flags as TOPIQ's forward sees them, during the scan
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, _: in_topiq.append(tf32_flags())
        if isinstance(module, TOPIQNet) else None)
    with tempfile.TemporaryDirectory() as tmp:
        photo_dir = os.path.join(tmp, "photos")
        os.makedirs(photo_dir)
        paths = write_photos(photo_dir)
        db = os.path.join(tmp, "scan.db")
        cfg = os.path.join(tmp, "scoring_config.json")
        entropy.hs_entropy.launches = 0
        attention.cross_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        rc = cli_main([photo_dir, "--pass", "quality", "--db", db,
                       "--config", cfg])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = {"hs_entropy": entropy.hs_entropy.launches,
                    "cross_attention": attention.cross_attention.launches}
        hook.remove()
        if rc != 0:
            raise AssertionError(f"scan exited {rc}")
        conn = sqlite3.connect(db)
        rows = conn.execute(
            "SELECT path, aesthetic, topiq_score, phash, raw_color_entropy,"
            " aggregate, scoring_model FROM photos").fetchall()
        conn.close()
    if len(rows) != len(paths):
        raise AssertionError(f"{len(rows)} rows for {len(paths)} photos")
    for row in rows:
        if any(v is None for v in row[1:6]):
            raise AssertionError(f"null column in row {row}")
        if row[6] != "topiq":
            raise AssertionError(f"row scored by {row[6]!r}, not topiq: {row}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched during the scan")
    if not in_topiq or any(any(flags) for flags in in_topiq):
        raise AssertionError(f"TOPIQ's forward ran with TF32 flags {in_topiq}; "
                             f"it must run in full float32")
    phase("scan", f"TF32 flags (cudnn, matmul) inside TOPIQ's {len(in_topiq)} "
                  f"forwards: {sorted(set(in_topiq))}; after the scan: "
                  f"{tf32_flags()}")
    phase("scan", f"{len(rows)} rows complete; kernel launches during the scan "
                  f"{launches}; {len(paths) / seconds:.2f} images/s end to end "
                  f"({seconds:.1f} s incl. model build, {gpu})")
    return launches


def main():
    gpu = phase_device()
    phase_build()
    measured = phase_kernels(gpu)
    launches = phase_scan(gpu)
    report = {"kernels": [
        {"name": "hs_entropy", "route": "cuda",
         "source": "facet_tpu_torch/csrc/hs_entropy.cu",
         "replaces": "facet_tpu/ops/pallas_entropy.py:252",
         "launches": launches["hs_entropy"], **measured["hs_entropy"]},
        {"name": "cross_attention", "route": "cuda",
         "source": "facet_tpu_torch/csrc/cross_attention.cu",
         "replaces": "facet_tpu/ops/pallas_attn.py:96",
         "launches": launches["cross_attention"],
         **measured["cross_attention"]},
    ]}
    print(gpu)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

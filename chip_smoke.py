"""Smoke test of the PyTorch/CUDA port (facet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. device: CUDA must be present; print the card's name and power limit and
   which optional host packages import;
2. build: compile every kernel from facet_tpu_torch/csrc (one nvcc per
   source, all started together);
3. kernels against their plain PyTorch twins on the card, at the main
   path's shapes and at odd small ones: kernel 1 (H-S entropy) and kernel 3
   (its fixed denominator), kernel 4 (one-pass RGB stats), kernel 5 (gray
   stencil stats), kernel 2 (TOPIQ's cross-attention). Histograms and
   integer sums must be identical, entropy within 1e-5, attention within
   ATTN_TOL and ATTN_REL_RMS_TOL. Each reports the median times of kernel
   and twin from CUDA events, its bound (the least time the card could take
   for the same work) and, for kernel 2, the time of
   F.scaled_dot_product_attention on the same inputs in bf16 (a yardstick
   only: the port never calls it); then the whole statistics prepass is
   timed in both configurations;
4. the slice: ``python -m facet_tpu_torch <dir> --pass quality`` in-process
   over synthetic photos at full width (ViT-L/14 at 224 in bf16 with the
   aesthetic head, TOPIQ at 384 in f32), in the default stats configuration
   (kernels 1, 5 and 2 must launch, kernel 4 must not), then over the same
   photos into a fresh database with FACET_ENTROPY_IMPL=pallas_fused
   (kernels 4, 5 and 2 must launch, kernel 1 must not). Every row is
   checked; the two scans' rows must agree (pHash and the integer-derived
   columns identical, raw_color_entropy within 1e-5, stored scores within
   1e-3); TOPIQ must run with TF32 off in both although the process keeps
   torch's defaults.

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

from facet_tpu_torch.ops import attention, cuda_build, entropy, fused_stats, gray_stats
from facet_tpu_torch.ops.colorspace import rgb_to_gray, rgb_to_hsv
from facet_tpu_torch.ops.stats import ENTROPY_IMPLS, batch_stats

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
SCORE_TOL = 1e-3
SCAN_SHAPES = ((1024, 1536), (768, 1024))
SCAN_COUNTS = (24, 8)

# H100 SXM peaks (NVIDIA's data sheet, at a 700 W limit): HBM3 bytes/s;
# dense bf16 tensor-core FLOP/s; 32-bit operations outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_OPS = 67e12
# 32-bit ALU operations per pixel of each statistics kernel's arithmetic
# (their histograms and sums, not the address math): kernel 1 bins and
# checks a (hue, sat) pair; kernel 5 evaluates two 3x3 stencils, a square,
# an absolute value and three sums; kernel 4 computes gray, V, min, diff, S,
# H with its branch and fix-up, two bins and a sum
OPS_PER_PIXEL = {"hs_entropy": 4, "gray_stats": 26, "fused_stats": 40}


def bound(bytes_moved, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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


def synthetic_photos(n, h, w, seed, degenerate=False):
    """Smooth colour fields with noise: photo-like hue/sat histograms.
    ``degenerate`` plants tests/test_pallas_fused_stats.py's pixels in the
    first image: gray (diff = 0), black (v = 0) and pure red."""
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
    if degenerate:
        out[0][0, 0], out[0][0, 1 % w], out[0][0, 2 % w] = 128, 0, (255, 0, 0)
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
        if "entry function" in ln or "registers" in ln or "spill" in ln:
            phase("build", ln.strip())


def stats_batch(b, h, w, seed):
    """(B, H, W, 3) uint8 on the card, with the degenerate pixels."""
    return torch.from_numpy(np.stack(synthetic_photos(b, h, w, seed, True))).cuda()


def check_entropy(gpu):
    """Kernel 1 vs its twin: the scan's own batches (the reported time is
    the first), the fast tier's stride 4 and an odd h*w; exact histograms.
    Its bound: the int32 hue and saturation it reads, 8 B per counted
    pixel."""
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
        n_eff = b * -(-h * w // stride)
        bound_ms, bound_by = bound(n_eff * 8 + b * 4,
                                   n_eff * OPS_PER_PIXEL["hs_entropy"], FP32_OPS)
        phase("kernels", f"hs_entropy B={b} {h}x{w} stride={stride}: histogram "
                         f"exact, max|d entropy|={err:.3g}, kernel {ms:.3f} ms, "
                         f"twin {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}) ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return report


def check_entropy_fixed(gpu):
    """Kernel 3 (kernel 1 with n_valid) vs its twin at the scan's batches
    and an odd h*w, with -1 hue markers on the last tenth of each image
    that count in n_valid but land in no bin."""
    report = {"max_abs_err": 0.0}
    cases = [(n, h, w) for (h, w), n in zip(SCAN_SHAPES, SCAN_COUNTS)] + [(3, 37, 53)]
    for b, h, w in cases:
        rgb = stats_batch(b, h, w, seed=h + 3)
        hh, ss, _ = rgb_to_hsv(rgb)
        hue = hh.reshape(b, -1).contiguous()
        sat = ss.reshape(b, -1).contiguous()
        hue[:, -(h * w // 10):] = -1
        n_valid = h * w
        got = entropy.hs_entropy(hue, sat, n_valid=n_valid)
        want = entropy.hs_entropy_plain(hue, sat, n_valid=n_valid)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > ENTROPY_TOL:
            raise AssertionError(f"fixed-denominator entropy err {err} > "
                                 f"{ENTROPY_TOL} at {(b, h, w)}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: entropy.hs_entropy(hue, sat, n_valid=n_valid))
        plain_ms = cuda_median_ms(
            lambda: entropy.hs_entropy_plain(hue, sat, n_valid=n_valid))
        bound_ms, bound_by = bound(b * h * w * 8 + b * 4,
                                   b * h * w * OPS_PER_PIXEL["hs_entropy"], FP32_OPS)
        phase("kernels", f"hs_entropy n_valid B={b} {h}x{w}: max|d entropy|="
                         f"{err:.3g}, kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, "
                         f"bound {bound_ms:.4f} ms ({bound_by}) ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return report


def check_fused_stats(gpu):
    """Kernel 4 vs its twin at the scan's batches and at (3, 37, 53), where
    h*w is odd and not a multiple of 4: identical gray histograms and
    saturation pairs, entropy within ENTROPY_TOL. Its bound: the uint8 RGB
    read once, and the outputs."""
    report = {"max_abs_err": 0.0}
    cases = [(n, h, w) for (h, w), n in zip(SCAN_SHAPES, SCAN_COUNTS)] + [(3, 37, 53)]
    for b, h, w in cases:
        rgb = stats_batch(b, h, w, seed=h + 4)
        got = fused_stats.fused_stats(rgb)
        want = fused_stats.fused_stats_plain(rgb)
        torch.cuda.synchronize()
        if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
            raise AssertionError(f"fused_stats histogram or saturation differs at "
                                 f"{(b, h, w)}")
        err = float((got[0] - want[0]).abs().max())
        if err > ENTROPY_TOL:
            raise AssertionError(f"fused_stats entropy err {err} > {ENTROPY_TOL} "
                                 f"at {(b, h, w)}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: fused_stats.fused_stats(rgb))
        plain_ms = cuda_median_ms(lambda: fused_stats.fused_stats_plain(rgb))
        bound_ms, bound_by = bound(b * h * w * 3 + b * (4 + 256 * 4 + 16),
                                   b * h * w * OPS_PER_PIXEL["fused_stats"], FP32_OPS)
        phase("kernels", f"fused_stats B={b} {h}x{w}: histogram and saturation "
                         f"exact, max|d entropy|={err:.3g}, kernel {ms:.3f} ms, "
                         f"twin {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}) ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return report


def check_gray_stats(gpu):
    """Kernel 5 vs its twin at the scan's batches and at (2, 3, 3), the
    smallest image the engine takes, and (3, 37, 53): every output
    identical. Its bound: the int32 gray plane read once, and the outputs."""
    report = {"max_abs_err": 0}
    cases = [(n, h, w) for (h, w), n in zip(SCAN_SHAPES, SCAN_COUNTS)]
    cases += [(2, 3, 3), (3, 37, 53)]
    for b, h, w in cases:
        gray = rgb_to_gray(stats_batch(b, h, w, seed=h + 5)).contiguous()
        got = gray_stats.fused_gray_stats(gray)
        want = gray_stats.fused_gray_stats_plain(gray)
        torch.cuda.synchronize()
        for name, g, x in zip(("hist", "lap_sum", "lap_sumsq", "imm_abs"), got, want):
            if not torch.equal(g, x):
                raise AssertionError(f"gray_stats {name} differs at {(b, h, w)}")
        ms = cuda_median_ms(lambda: gray_stats.fused_gray_stats(gray))
        plain_ms = cuda_median_ms(lambda: gray_stats.fused_gray_stats_plain(gray))
        bound_ms, bound_by = bound(b * h * w * 4 + b * (256 * 4 + 3 * 8),
                                   b * h * w * OPS_PER_PIXEL["gray_stats"], FP32_OPS)
        phase("kernels", f"gray_stats B={b} {h}x{w}: every output exact, kernel "
                         f"{ms:.3f} ms, twin {plain_ms:.3f} ms, bound "
                         f"{bound_ms:.4f} ms ({bound_by}) ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return report


def attention_errors(got, want):
    """(max |got - want|, RMS of got - want over the RMS of want)."""
    diff = (got - want).double()
    return (float(diff.abs().max()),
            float(diff.pow(2).mean().sqrt() / want.double().pow(2).mean().sqrt()))


def check_attention(gpu):
    """Kernel 2 vs its twin: TOPIQ's C2 level at 384 px for the scan's own
    batches (the reported time is the first), then batch 4 at 384 px and at
    the fast tier's 256 px. Its bound: 4*B*H*Nq*Nk*D bf16 tensor-core FLOP
    (QK^T and PV) against q, k, v and out in f32 read or written once; its
    library yardstick: F.scaled_dot_product_attention on q, k, v in bf16."""
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
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        library_ms = cuda_median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qb, kb, vb))
        del qb, kb, vb
        bound_ms, bound_by = bound(b * h * (2 * nq + 2 * nk) * 64 * 4,
                                   4 * b * h * nq * nk * 64, BF16_FLOPS)
        phase("kernels", f"cross_attention ({b},{h},{nq},{nk},64): "
                         f"max|d|={err:.3g} (tol {ATTN_TOL}), relative RMS "
                         f"{rel_rms:.3g} (tol {ATTN_REL_RMS_TOL}), kernel "
                         f"{ms:.3f} ms, twin {plain_ms:.3f} ms, SDPA bf16 "
                         f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}) ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        del q, k, v, got, want
    return report


def time_prepass(gpu):
    """The whole statistics prepass (ops/stats.py:batch_stats) in both
    configurations at the scan's batches, as the fused pass calls it: the
    layer the stats kernels serve, kernels and plain ops together."""
    for (h, w), b in zip(SCAN_SHAPES, SCAN_COUNTS):
        rgb = stats_batch(b, h, w, seed=h + 6)
        times = {impl: cuda_median_ms(lambda: batch_stats(rgb, 1, impl))
                 for impl in ENTROPY_IMPLS}
        phase("kernels", f"stats prepass B={b} {h}x{w}: " + ", ".join(
            f"{impl} {ms:.3f} ms" for impl, ms in times.items()) + f" ({gpu})")


def phase_kernels(gpu):
    report = {"hs_entropy": check_entropy(gpu),
              "hs_entropy_fixed": check_entropy_fixed(gpu),
              "fused_stats": check_fused_stats(gpu),
              "gray_stats": check_gray_stats(gpu),
              "cross_attention": check_attention(gpu)}
    time_prepass(gpu)
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


# every launch counter the scans read: name -> (wrapper, attribute)
COUNTERS = {"hs_entropy": (entropy.hs_entropy, "launches"),
            "hs_entropy_fixed": (entropy.hs_entropy, "launches_fixed"),
            "fused_stats": (fused_stats.fused_stats, "launches"),
            "gray_stats": (gray_stats.fused_gray_stats, "launches"),
            "cross_attention": (attention.cross_attention, "launches")}
# kernels each stats configuration's scan must launch, and must not
SCAN_CONFIGS = {
    "pallas": ({"hs_entropy", "gray_stats", "cross_attention"}, {"fused_stats"}),
    "pallas_fused": ({"fused_stats", "gray_stats", "cross_attention"}, {"hs_entropy"}),
}
ROW_COLUMNS = ("path", "aesthetic", "topiq_score", "quality_score", "phash",
               "raw_color_entropy", "color_score", "aggregate", "scoring_model",
               "histogram_data", "histogram_spread", "mean_luminance",
               "histogram_bimodality", "exposure_score", "shadow_clipped",
               "highlight_clipped", "is_silhouette", "raw_sharpness_variance",
               "tech_sharpness", "noise_sigma", "mean_saturation", "is_monochrome",
               "contrast_score", "dynamic_range_stops")
# columns the two stats configurations must write identically: the pHash
# and everything derived from the integer statistics alone
EXACT_COLUMNS = ("phash", "histogram_data", "histogram_spread", "mean_luminance",
                 "histogram_bimodality", "exposure_score", "shadow_clipped",
                 "highlight_clipped", "is_silhouette", "raw_sharpness_variance",
                 "tech_sharpness", "noise_sigma", "mean_saturation", "is_monochrome",
                 "contrast_score", "dynamic_range_stops")
SCORE_COLUMNS = ("aesthetic", "topiq_score", "quality_score", "color_score", "aggregate")


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


def run_scan(photo_dir, db, cfg, impl, gpu):
    """One --pass quality scan with FACET_ENTROPY_IMPL=impl -> (rows,
    launches). Counts are zeroed just before and read just after."""
    from facet_tpu_torch.__main__ import main as cli_main
    from facet_tpu_torch.models.topiq import TOPIQNet

    in_topiq = []     # the flags as TOPIQ's forward sees them, during the scan
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, _: in_topiq.append(tf32_flags())
        if isinstance(module, TOPIQNet) else None)
    os.environ["FACET_ENTROPY_IMPL"] = impl
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.time()
    rc = cli_main([photo_dir, "--pass", "quality", "--db", db, "--config", cfg])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}
    hook.remove()
    del os.environ["FACET_ENTROPY_IMPL"]
    if rc != 0:
        raise AssertionError(f"scan ({impl}) exited {rc}")
    conn = sqlite3.connect(db)
    rows = [dict(zip(ROW_COLUMNS, r)) for r in conn.execute(
        f"SELECT {', '.join(ROW_COLUMNS)} FROM photos ORDER BY path")]
    conn.close()
    for row in rows:
        if any(row[c] is None for c in ("aesthetic", "topiq_score", "phash",
                                        "raw_color_entropy", "aggregate")):
            raise AssertionError(f"null column in row {row['path']} ({impl})")
        if row["scoring_model"] != "topiq":
            raise AssertionError(f"row scored by {row['scoring_model']!r}, not "
                                 f"topiq: {row['path']} ({impl})")
    must, must_not = SCAN_CONFIGS[impl]
    for name in must:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched during the {impl} scan")
    for name in must_not:
        if launches[name] != 0:
            raise AssertionError(f"kernel {name} launched {launches[name]} times "
                                 f"during the {impl} scan")
    if not in_topiq or any(any(flags) for flags in in_topiq):
        raise AssertionError(f"TOPIQ's forward ran with TF32 flags {in_topiq} "
                             f"({impl}); it must run in full float32")
    phase("scan", f"{impl}: TF32 flags (cudnn, matmul) inside TOPIQ's "
                  f"{len(in_topiq)} forwards: {sorted(set(in_topiq))}; after the "
                  f"scan: {tf32_flags()}")
    phase("scan", f"{impl}: {len(rows)} rows complete; kernel launches during "
                  f"the scan {launches}; {len(rows) / seconds:.2f} images/s end "
                  f"to end ({seconds:.1f} s, {gpu})")
    return rows, launches


def compare_rows(got, want):
    """The pallas_fused scan's rows against the default scan's."""
    if [r["path"] for r in got] != [r["path"] for r in want]:
        raise AssertionError("the two scans wrote different photos")
    worst = {"raw_color_entropy": 0.0, "scores": 0.0}
    for g, w in zip(got, want):
        for col in EXACT_COLUMNS:
            if g[col] != w[col]:
                raise AssertionError(f"{col} differs between the scans at {g['path']}")
        d = abs(g["raw_color_entropy"] - w["raw_color_entropy"])
        if d > ENTROPY_TOL:
            raise AssertionError(f"raw_color_entropy differs by {d} at {g['path']}")
        worst["raw_color_entropy"] = max(worst["raw_color_entropy"], d)
        for col in SCORE_COLUMNS:
            d = abs(g[col] - w[col])
            if d > SCORE_TOL:
                raise AssertionError(f"{col} differs by {d} at {g['path']}")
            worst["scores"] = max(worst["scores"], d)
    return worst


def phase_scan(gpu):
    phase("scan", f"process TF32 flags (cudnn, matmul), torch's defaults: "
                  f"{tf32_flags()}")
    with tempfile.TemporaryDirectory() as tmp:
        photo_dir = os.path.join(tmp, "photos")
        os.makedirs(photo_dir)
        paths = write_photos(photo_dir)
        cfg = os.path.join(tmp, "scoring_config.json")
        scans = {impl: run_scan(photo_dir, os.path.join(tmp, f"{impl}.db"), cfg,
                                impl, gpu) for impl in SCAN_CONFIGS}
    for rows, _ in scans.values():
        if len(rows) != len(paths):
            raise AssertionError(f"{len(rows)} rows for {len(paths)} photos")
    worst = compare_rows(scans["pallas_fused"][0], scans["pallas"][0])
    phase("scan", f"pallas_fused rows against the default's: pHash and integer "
                  f"columns identical, max|d raw_color_entropy|="
                  f"{worst['raw_color_entropy']:.3g} (tol {ENTROPY_TOL}), max|d "
                  f"score|={worst['scores']:.3g} (tol {SCORE_TOL})")
    return {impl: launches for impl, (_, launches) in scans.items()}


# name -> (source, the TPU kernel it replaces, the scan whose count is its
# launches on the main path; kernel 3 is on no path of the engine)
KERNELS = {
    "hs_entropy": ("facet_tpu_torch/csrc/hs_entropy.cu",
                   "facet_tpu/ops/pallas_entropy.py:252", "pallas"),
    "hs_entropy_fixed": ("facet_tpu_torch/csrc/hs_entropy.cu",
                         "facet_tpu/ops/pallas_entropy.py:116", "pallas"),
    "fused_stats": ("facet_tpu_torch/csrc/fused_stats.cu",
                    "facet_tpu/ops/pallas_fused_stats.py:236", "pallas_fused"),
    "gray_stats": ("facet_tpu_torch/csrc/gray_stats.cu",
                   "facet_tpu/ops/pallas_stats.py:168", "pallas"),
    "cross_attention": ("facet_tpu_torch/csrc/cross_attention.cu",
                        "facet_tpu/ops/pallas_attn.py:96", "pallas"),
}


def main():
    gpu = phase_device()
    phase_build()
    measured = phase_kernels(gpu)
    launches = phase_scan(gpu)
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[scan][name],
         "launches_by_scan": {impl: counts[name] for impl, counts in launches.items()},
         **measured[name]}
        for name, (source, replaces, scan) in KERNELS.items()]}
    print(gpu)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Separable image resizing as matmuls.

Counterpart of ``facet_tpu/ops/resize.py``. The numpy weight-matrix builders
are carried over unchanged, because the original module imports jax at the
top; ``apply_separable_resize`` is the same two contractions in torch.
"""

import functools

import numpy as np
import torch


def _cubic_kernel(x, a=-0.5):
    """Catmull-Rom bicubic kernel (PIL's convention, a=-0.5)."""
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x <= 1
    out[m1] = ((a + 2) * x[m1] - (a + 3)) * x[m1] * x[m1] + 1
    m2 = (x > 1) & (x < 2)
    out[m2] = (((x[m2] - 5) * x[m2] + 8) * x[m2] - 4) * a
    return out


def _linear_kernel(x):
    x = np.abs(x)
    return np.clip(1 - x, 0, None)


@functools.lru_cache(maxsize=512)
def resample_matrix(src, dst, scale=None, offset=0.0, method="cubic", antialias=True):
    """(dst, src) float32 weight matrix for one axis.

    scale: output/input scale (default dst/src). offset: crop offset in
    *scaled* coordinates (for center crops). Antialiasing widens the kernel
    support by 1/scale when downscaling, like PIL/torchvision.
    """
    if scale is None:
        scale = dst / src
    kernel = _cubic_kernel if method == "cubic" else _linear_kernel
    support = 2.0 if method == "cubic" else 1.0
    filter_scale = max(1.0 / scale, 1.0) if antialias else 1.0
    support = support * filter_scale

    weights = np.zeros((dst, src), np.float32)
    for i in range(dst):
        center = (i + 0.5 + offset) / scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        idx = np.arange(lo, hi + 1)
        w = kernel((idx - center) / filter_scale)
        idx_clamped = np.clip(idx, 0, src - 1)  # edge clamp, like PIL
        total = w.sum()
        if total > 0:
            w = w / total
        np.add.at(weights[i], idx_clamped, w.astype(np.float32))
    return weights


def clip_preprocess_matrices(src_h, src_w, target=224):
    """Row/col matrices implementing shortest-side resize + center crop."""
    scale = target / min(src_h, src_w)
    resized_h = round(src_h * scale)
    resized_w = round(src_w * scale)
    off_h = (resized_h - target) / 2.0
    off_w = (resized_w - target) / 2.0
    rows = resample_matrix(src_h, target, scale=scale, offset=off_h)
    cols = resample_matrix(src_w, target, scale=scale, offset=off_w)
    return rows, cols


def apply_separable_resize(images, rows, cols):
    """(B, H, W, C) x (H', H) x (W', W) -> (B, H', W', C) float32."""
    x = images.to(torch.float32)
    x = torch.einsum("rh,bhwc->brwc", rows, x)
    return torch.einsum("sw,brwc->brsc", cols, x)

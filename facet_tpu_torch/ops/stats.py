"""Per-image statistics: the device half of the technical suite.

Counterpart of ``facet_tpu/ops/stats.py``. For a batch of same-shape RGB
uint8 images it computes every reduction the classical metrics need:

- the 256-bin exact-cv2 gray histogram;
- the exact-cv2 HSV saturation sum;
- Laplacian sum and sum of squares and the |Immerkaer| sum, from 3x3
  stencils with reflect-101 borders (cv2's default);
- the H-S joint entropy, over every ``hs_subsample``-th pixel in the fast
  tier.

``entropy_impl`` picks one of the two configurations the JAX package runs
on a TPU (``FACET_ENTROPY_IMPL``, resolved once by ``resolve_entropy_impl``):

- ``pallas`` (the default): entropy from kernel 1 (``ops/entropy.py``) over
  the hue and saturation planes; gray histogram and stencil sums from
  kernel 5 (``ops/gray_stats.py``); saturation sum a plain reduction.
- ``pallas_fused``, exact tier: entropy, gray histogram and saturation sum
  from kernel 4 (``ops/fused_stats.py``) in one read of the RGB; stencil
  sums from kernel 5. In the fast tier it runs the ``pallas``
  configuration, as the JAX package does.

The JAX package's other values (``xla``, ``none``, ``zero``: the TPU's
measuring modes) have no counterpart here and raise. On a CPU tensor every
kernel wrapper computes its plain twin.

The outputs keep the JAX package's ``(hi, lo)`` split pairs (``hi = total
>> shift``, ``lo = total & (2**shift - 1)``) so that ``split_total`` and
``ImageStats`` are unchanged and exact above 16 MP.
"""

import os
from dataclasses import dataclass

import numpy as np
import torch

from facet_tpu_torch.ops.colorspace import rgb_to_gray, rgb_to_hsv
from facet_tpu_torch.ops.entropy import hs_entropy
from facet_tpu_torch.ops.fused_stats import fused_stats, split_pair
from facet_tpu_torch.ops.gray_stats import fused_gray_stats

CHUNK = 256     # images per device call for one shape
ENTROPY_IMPLS = ("pallas", "pallas_fused")


@dataclass
class ImageStats:
    """Host-side view of one image's device statistics."""

    height: int
    width: int
    gray_hist: np.ndarray      # (256,) int32, exact counts
    sat_sum: int               # exact sum of S channel
    hs_entropy: float          # bits, f32 device reduction
    lap_sum: int               # exact sum of Laplacian responses
    lap_sumsq: int             # exact sum of squared responses
    imm_abs_sum: int           # exact sum of |Immerkaer| responses

    @property
    def n_pixels(self):
        return self.height * self.width

    def laplacian_variance(self):
        n = self.n_pixels
        # exact integer arithmetic first; one float64 rounding at the end
        return float(self.lap_sumsq * n - self.lap_sum * self.lap_sum) / (n * n)

    def mean_saturation(self):
        return self.sat_sum / self.n_pixels / 255.0


def split_total(pair, shift):
    """Host side of the split pair: (2,) ints -> exact Python int."""
    return (int(pair[0]) << shift) + int(pair[1])


def resolve_entropy_impl(impl="auto"):
    """The stats configuration: ``FACET_ENTROPY_IMPL`` when set, else
    ``impl``; "auto" is "pallas". Anything but ENTROPY_IMPLS raises."""
    impl = os.environ.get("FACET_ENTROPY_IMPL", impl)
    if impl == "auto":
        return "pallas"
    if impl not in ENTROPY_IMPLS:
        raise ValueError(
            f"FACET_ENTROPY_IMPL={impl!r} has no counterpart in facet_tpu_torch: "
            f"the port runs {ENTROPY_IMPLS} (the TPU's measuring modes xla, "
            f"none and zero are not ported)")
    return impl


def batch_stats(rgb_batch, hs_subsample=1, entropy_impl="pallas"):
    """(B, H, W, 3) uint8 tensor -> (gray_hist (B, 256) int32, sat pair,
    entropy (B,) f32, lap pair, lapsq pair, imm pair); pairs (B, 2) int64."""
    if entropy_impl not in ENTROPY_IMPLS:
        raise ValueError(f"entropy_impl must be one of {ENTROPY_IMPLS}, "
                         f"got {entropy_impl!r}")
    b = rgb_batch.shape[0]
    gray_hist, lap_sum, lapsq_sum, imm_sum = fused_gray_stats(rgb_to_gray(rgb_batch))
    if entropy_impl == "pallas_fused" and hs_subsample == 1:
        entropy, gray_hist, sat = fused_stats(rgb_batch)
    else:
        hh, ss, _ = rgb_to_hsv(rgb_batch)
        sat = split_pair(ss.reshape(b, -1).sum(dim=1, dtype=torch.int64), 12)
        entropy = hs_entropy(hh.reshape(b, -1), ss.reshape(b, -1), stride=hs_subsample)
    return (gray_hist, sat, entropy, split_pair(lap_sum, 12),
            split_pair(lapsq_sum, 16), split_pair(imm_sum, 12))


def stats_from_outputs(h, w, gray_hist, sat, entropy, lap, lapsq, imm):
    """One image's fetched numpy outputs -> ImageStats."""
    return ImageStats(
        height=h, width=w, gray_hist=np.asarray(gray_hist, np.int32),
        sat_sum=split_total(sat, 12), hs_entropy=float(entropy),
        lap_sum=split_total(lap, 12), lap_sumsq=split_total(lapsq, 16),
        imm_abs_sum=split_total(imm, 12))


def compute_batch_stats(images, device, hs_subsample=1, entropy_impl="auto"):
    """List of RGB uint8 numpy arrays -> aligned list of ImageStats.

    Images are grouped by (H, W) and sent in chunks of CHUNK; there is no
    batch padding (eager PyTorch has no recompiles to bound).
    """
    entropy_impl = resolve_entropy_impl(entropy_impl)
    results = [None] * len(images)
    by_shape = {}
    for i, img in enumerate(images):
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"image {i}: expected (H, W, 3) RGB, got {img.shape}")
        if img.shape[0] < 3 or img.shape[1] < 3:
            raise ValueError(f"image {i}: too small for 3x3 stencils: {img.shape}")
        by_shape.setdefault(img.shape[:2], []).append(i)
    for (h, w), indices in by_shape.items():
        for pos in range(0, len(indices), CHUNK):
            chunk = indices[pos:pos + CHUNK]
            batch = torch.from_numpy(np.stack([images[i] for i in chunk])).to(device)
            outs = [t.cpu().numpy()
                    for t in batch_stats(batch, hs_subsample, entropy_impl)]
            for j, idx in enumerate(chunk):
                results[idx] = stats_from_outputs(h, w, *(o[j] for o in outs))
    return results

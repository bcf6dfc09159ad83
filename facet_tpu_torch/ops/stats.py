"""Per-image statistics: the device half of the technical suite.

Counterpart of ``facet_tpu/ops/stats.py``. For a batch of same-shape RGB
uint8 images it computes every reduction the classical metrics need:

- the 256-bin exact-cv2 gray histogram (``bincount``);
- the exact-cv2 HSV saturation sum;
- Laplacian sum and sum of squares and the |Immerkaer| sum, from 3x3
  stencils with reflect-101 borders (cv2's default);
- the H-S joint entropy through kernel 1 (``ops/entropy.py``), over every
  ``hs_subsample``-th pixel in the fast tier.

The TPU package avoided scatters (one-hot matmul histograms) and split its
int64-range sums into two int32 streams. Here the histograms are bincounts
and the sums int64; the outputs keep the JAX package's ``(hi, lo)`` split
pairs (``hi = total >> shift``, ``lo = total & (2**shift - 1)``) so that
``split_total`` and ``ImageStats`` are unchanged and exact above 16 MP.
"""

from dataclasses import dataclass

import numpy as np
import torch

from facet_tpu_torch.ops.colorspace import rgb_to_gray, rgb_to_hsv
from facet_tpu_torch.ops.entropy import hs_entropy

CHUNK = 256     # images per device call for one shape


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


def split_pair(total, shift):
    """(B,) int64 exact totals -> (B, 2) int64 (hi, lo) pairs."""
    return torch.stack([total >> shift, total & ((1 << shift) - 1)], dim=1)


def split_total(pair, shift):
    """Host side of the split pair: (2,) ints -> exact Python int."""
    return (int(pair[0]) << shift) + int(pair[1])


def _reflect101(x):
    """(B, H, W) -> (B, H+2, W+2) with cv2's BORDER_REFLECT_101."""
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], dim=1)
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)


def batch_stats(rgb_batch, hs_subsample=1):
    """(B, H, W, 3) uint8 tensor -> (gray_hist (B, 256) int32, sat pair,
    entropy (B,) f32, lap pair, lapsq pair, imm pair); pairs (B, 2) int64."""
    b, h, w, _ = rgb_batch.shape
    gray = rgb_to_gray(rgb_batch)
    hh, ss, _ = rgb_to_hsv(rgb_batch)

    sat_sum = ss.reshape(b, -1).sum(dim=1, dtype=torch.int64)
    offsets = torch.arange(b, device=gray.device)[:, None] * 256
    gray_hist = torch.bincount((gray.reshape(b, -1).long() + offsets).reshape(-1),
                               minlength=b * 256).view(b, 256).to(torch.int32)

    p = _reflect101(gray)
    c = p[:, 1:-1, 1:-1]
    lap = p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:] - 4 * c
    imm = (p[:, :-2, :-2] - 2 * p[:, :-2, 1:-1] + p[:, :-2, 2:]
           - 2 * p[:, 1:-1, :-2] + 4 * c - 2 * p[:, 1:-1, 2:]
           + p[:, 2:, :-2] - 2 * p[:, 2:, 1:-1] + p[:, 2:, 2:])
    lap_sum = lap.sum(dim=(1, 2), dtype=torch.int64)
    lapsq_sum = (lap * lap).sum(dim=(1, 2), dtype=torch.int64)   # lap^2 <= 1040400
    imm_sum = imm.abs().sum(dim=(1, 2), dtype=torch.int64)

    entropy = hs_entropy(hh.reshape(b, -1), ss.reshape(b, -1), stride=hs_subsample)
    return (gray_hist, split_pair(sat_sum, 12), entropy, split_pair(lap_sum, 12),
            split_pair(lapsq_sum, 16), split_pair(imm_sum, 12))


def stats_from_outputs(h, w, gray_hist, sat, entropy, lap, lapsq, imm):
    """One image's fetched numpy outputs -> ImageStats."""
    return ImageStats(
        height=h, width=w, gray_hist=np.asarray(gray_hist, np.int32),
        sat_sum=split_total(sat, 12), hs_entropy=float(entropy),
        lap_sum=split_total(lap, 12), lap_sumsq=split_total(lapsq, 16),
        imm_abs_sum=split_total(imm, 12))


def compute_batch_stats(images, device, hs_subsample=1):
    """List of RGB uint8 numpy arrays -> aligned list of ImageStats.

    Images are grouped by (H, W) and sent in chunks of CHUNK; there is no
    batch padding (eager PyTorch has no recompiles to bound).
    """
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
            outs = [t.cpu().numpy() for t in batch_stats(batch, hs_subsample)]
            for j, idx in enumerate(chunk):
                results[idx] = stats_from_outputs(h, w, *(o[j] for o in outs))
    return results

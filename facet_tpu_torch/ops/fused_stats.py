"""One-pass RGB statistics: kernel 4 of the port.

``fused_stats(rgb)`` is the counterpart of
``facet_tpu/ops/pallas_fused_stats.py:fused_stats_pallas``: for a
(B, H, W, 3) uint8 batch it returns the H-S joint entropy (B,) float32
(normalized by the in-range count), the exact-cv2 gray histogram (B, 256)
int32 and the exact-cv2 saturation sum as the (B, 2) int64 pair
``split_pair(total, 12)``, from one read of the RGB. On a CUDA tensor it
launches the kernel in ``csrc/fused_stats.cu``; on a CPU tensor it computes
the plain twin ``fused_stats_plain``.
"""

import ctypes
import functools

import torch

from facet_tpu_torch.ops import cuda_build
from facet_tpu_torch.ops.colorspace import rgb_to_gray, rgb_to_hsv
from facet_tpu_torch.ops.entropy import hs_entropy_plain
from facet_tpu_torch.ops.gray_stats import gray_histogram_plain


def split_pair(total, shift):
    """(B,) int64 exact totals -> (B, 2) int64 (hi, lo) pairs."""
    return torch.stack([total >> shift, total & ((1 << shift) - 1)], dim=1)


def _check(rgb):
    if rgb.dim() != 4 or rgb.shape[3] != 3:
        raise ValueError(f"rgb must be (B, H, W, 3), got {tuple(rgb.shape)}")
    if rgb.dtype != torch.uint8:
        raise TypeError(f"rgb must be uint8, got {rgb.dtype}")
    if not rgb.is_contiguous():
        raise ValueError("rgb must be contiguous")
    if rgb.shape[0] < 1 or rgb.shape[1] * rgb.shape[2] < 1:
        raise ValueError(f"empty batch {tuple(rgb.shape)}")


def fused_stats_plain(rgb):
    """Plain PyTorch twin: rgb_to_gray / rgb_to_hsv, bincounts, an int64
    saturation sum and the entropy formula."""
    _check(rgb)
    b = rgb.shape[0]
    hh, ss, _ = rgb_to_hsv(rgb)
    entropy = hs_entropy_plain(hh.reshape(b, -1), ss.reshape(b, -1))
    sat = ss.reshape(b, -1).sum(dim=1, dtype=torch.int64)
    return entropy, gray_histogram_plain(rgb_to_gray(rgb)), split_pair(sat, 12)


@functools.lru_cache(maxsize=None)
def scratch_ints(batch):
    """int32s of the kernel's scratch (csrc/fused_stats.cu): kernel 1's
    workspace for one slice an image, the gray histograms and the
    saturation totals; the kernel clears it."""
    ints = ctypes.c_longlong()
    cuda_build.check(cuda_build.library().facet_fused_stats_scratch(
        batch, ctypes.byref(ints)), "fused_stats_scratch")
    return ints.value


def fused_stats(rgb):
    """(B, H, W, 3) uint8 -> (entropy (B,) f32, gray_hist (B, 256) int32,
    sat pair (B, 2) int64), on the tensor's device."""
    _check(rgb)
    if rgb.device.type == "cpu":
        return fused_stats_plain(rgb)
    if rgb.device.type != "cuda":
        raise ValueError(f"fused_stats: unsupported device {rgb.device}")
    b, h, w, _ = rgb.shape
    if b > 65535:
        raise ValueError(f"fused_stats: batch {b} exceeds the grid limit 65535")
    dev = rgb.device
    scratch = torch.empty((scratch_ints(b),), dtype=torch.int32, device=dev)
    entropy = torch.empty((b,), dtype=torch.float32, device=dev)
    gray_hist = torch.empty((b, 256), dtype=torch.int32, device=dev)
    sat = torch.empty((b, 2), dtype=torch.int64, device=dev)
    with cuda_build.on_device(dev):
        err = cuda_build.library().facet_fused_stats(
            rgb.data_ptr(), scratch.data_ptr(), entropy.data_ptr(), gray_hist.data_ptr(),
            sat.data_ptr(), b, h * w, cuda_build.sm_count(dev), cuda_build.stream(dev))
    cuda_build.check(err, "fused_stats")
    fused_stats.launches += 1
    return entropy, gray_hist, sat


fused_stats.launches = 0

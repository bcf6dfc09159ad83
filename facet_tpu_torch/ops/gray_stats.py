"""Gray-plane statistics: kernel 5 of the port.

``fused_gray_stats(gray)`` is the counterpart of
``facet_tpu/ops/pallas_stats.py:fused_gray_stats``: for a (B, H, W) int32
exact-cv2 gray plane it returns the 256-bin histogram (B, 256) int32 and,
over cv2's reflect-101 border, the Laplacian sum, the Laplacian sum of
squares and the |Immerkaer| sum, each (B,) int64. The JAX function returns
numpy; these stay on the device until the fused pass fetches them. On a
CUDA tensor it launches the kernel in ``csrc/gray_stats.cu``; on a CPU
tensor it computes the plain twin ``fused_gray_stats_plain``.
"""

import math

import torch

from facet_tpu_torch.ops import cuda_build

# blocks per SM the launch aims for (256 threads each, 8 fit one SM)
_BLOCKS_PER_SM = 8
_TILE_H, _TILE_W = 16, 128      # csrc/gray_stats.cu's kTileH, kTileW


def _check(gray):
    if gray.dim() != 3:
        raise ValueError(f"gray must be (B, H, W), got {tuple(gray.shape)}")
    if gray.dtype != torch.int32:
        raise TypeError(f"gray must be int32, got {gray.dtype}")
    if not gray.is_contiguous():
        raise ValueError("gray must be contiguous")
    b, h, w = gray.shape
    if b < 1 or h < 2 or w < 2:
        raise ValueError(f"reflect-101 stencils need H, W >= 2, got {tuple(gray.shape)}")


def gray_histogram_plain(gray):
    """(B, ...) int gray in 0..255 -> (B, 256) int32 counts (bincount)."""
    b = gray.shape[0]
    offsets = torch.arange(b, device=gray.device)[:, None] * 256
    return torch.bincount((gray.reshape(b, -1).long() + offsets).reshape(-1),
                          minlength=b * 256).view(b, 256).to(torch.int32)


def _reflect101(x):
    """(B, H, W) -> (B, H+2, W+2) with cv2's BORDER_REFLECT_101."""
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], dim=1)
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)


def fused_gray_stats_plain(gray):
    """Plain PyTorch twin: bincount histogram and the 3x3 stencils over a
    reflect-101-padded copy, summed in int64."""
    _check(gray)
    p = _reflect101(gray)
    c = p[:, 1:-1, 1:-1]
    lap = p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:] - 4 * c
    imm = (p[:, :-2, :-2] - 2 * p[:, :-2, 1:-1] + p[:, :-2, 2:]
           - 2 * p[:, 1:-1, :-2] + 4 * c - 2 * p[:, 1:-1, 2:]
           + p[:, 2:, :-2] - 2 * p[:, 2:, 1:-1] + p[:, 2:, 2:])
    return (gray_histogram_plain(gray),
            lap.sum(dim=(1, 2), dtype=torch.int64),
            (lap * lap).sum(dim=(1, 2), dtype=torch.int64),    # lap^2 <= 1040400
            imm.abs().sum(dim=(1, 2), dtype=torch.int64))


def blocks_for(batch, h, w, sm_count):
    """Blocks per image: about _BLOCKS_PER_SM per SM over the batch, at most
    one per tile."""
    tiles = math.ceil(h / _TILE_H) * math.ceil(w / _TILE_W)
    return max(1, min(tiles, math.ceil(_BLOCKS_PER_SM * sm_count / batch)))


def fused_gray_stats(gray):
    """(B, H, W) int32 gray -> (hist (B, 256) int32, lap_sum, lap_sumsq,
    imm_abs (B,) int64), on the tensor's device."""
    _check(gray)
    if gray.device.type == "cpu":
        return fused_gray_stats_plain(gray)
    if gray.device.type != "cuda":
        raise ValueError(f"fused_gray_stats: unsupported device {gray.device}")
    b, h, w = gray.shape
    if b > 65535:
        raise ValueError(f"fused_gray_stats: batch {b} exceeds the grid limit 65535")
    dev = gray.device
    hist = torch.zeros((b, 256), dtype=torch.int32, device=dev)
    sums = torch.zeros((b, 3), dtype=torch.int64, device=dev)
    with cuda_build.on_device(dev):
        err = cuda_build.library().facet_gray_stats(
            gray.data_ptr(), hist.data_ptr(), sums.data_ptr(), b, h, w,
            blocks_for(b, h, w, cuda_build.sm_count(dev)), cuda_build.stream(dev))
    cuda_build.check(err, "fused_gray_stats")
    fused_gray_stats.launches += 1
    return hist, sums[:, 0], sums[:, 1], sums[:, 2]


fused_gray_stats.launches = 0

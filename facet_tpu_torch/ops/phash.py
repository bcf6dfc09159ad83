"""64-bit perceptual hash (pHash).

Counterpart of ``facet_tpu/ops/phash.py``: exact-cv2 gray -> 32x32 area
resize -> 2-D DCT-II -> top-left 8x8 block -> threshold at the block median
(the mean of the two middle values, as ``jnp.median``) -> 64 bits. The
numpy matrix builders are carried over because the original module imports
jax at the top.
"""

import functools

import numpy as np
import torch

from facet_tpu_torch.ops.colorspace import rgb_to_gray

HASH_SIZE = 8
RESIZE = 32


@functools.lru_cache(maxsize=128)
def _area_weights(src, dst):
    """(dst, src) float32 exact area-interpolation weight matrix."""
    w = np.zeros((dst, src), np.float32)
    scale = src / dst
    for i in range(dst):
        left = i * scale
        right = (i + 1) * scale
        lo = int(np.floor(left))
        hi = int(np.ceil(right))
        for j in range(lo, min(hi, src)):
            overlap = min(right, j + 1) - max(left, j)
            if overlap > 0:
                w[i, j] = overlap / scale
    return w


@functools.lru_cache(maxsize=1)
def _dct_matrix():
    """(32, 32) DCT-II basis (scipy.fftpack.dct norm=None convention)."""
    n = RESIZE
    k = np.arange(n)[:, None]
    x = np.arange(n)[None, :]
    return (2.0 * np.cos(np.pi * k * (2 * x + 1) / (2 * n))).astype(np.float32)


def low_frequencies(gray, row_w, col_w, dct):
    """(B, H, W) f32 gray -> (B, 64) low-frequency DCT coefficients."""
    small = row_w @ gray @ col_w.T                  # (B, 32, 32)
    freq = dct @ small @ dct.T                      # 2-D DCT-II
    return freq[:, :HASH_SIZE, :HASH_SIZE].reshape(-1, HASH_SIZE * HASH_SIZE)


def hash_bits(low):
    """(B, 64) coefficients -> (B, 64) bool: above the median of 64."""
    srt = torch.sort(low, dim=1).values
    half = HASH_SIZE * HASH_SIZE // 2
    med = (srt[:, half - 1:half] + srt[:, half:half + 1]) * 0.5
    return low > med


def hash_matrices(h, w, device):
    """(row weights (32, H), col weights (32, W), DCT (32, 32)) on device."""
    return (torch.from_numpy(_area_weights(h, RESIZE)).to(device),
            torch.from_numpy(_area_weights(w, RESIZE)).to(device),
            torch.from_numpy(_dct_matrix()).to(device))


def _bits_to_hex(bits):
    """(64,) bool -> 16-char hex string (row-major, MSB first)."""
    val = 0
    for b in bits:
        val = (val << 1) | int(b)
    return f"{val:016x}"


def phash_batch(images, device):
    """Hash a list of RGB uint8 arrays; returns aligned list of hex strings."""
    results = [None] * len(images)
    by_shape = {}
    for i, img in enumerate(images):
        by_shape.setdefault(img.shape[:2], []).append(i)
    for (h, w), indices in by_shape.items():
        row_w, col_w, dct = hash_matrices(h, w, device)
        batch = torch.from_numpy(np.stack([images[i] for i in indices])).to(device)
        gray = rgb_to_gray(batch).to(torch.float32)
        bits = hash_bits(low_frequencies(gray, row_w, col_w, dct)).cpu().numpy()
        for j, idx in enumerate(indices):
            results[idx] = _bits_to_hex(bits[j])
    return results


def hamming_distance(hex_a, hex_b):
    """Bit distance between two hex hash strings (0-64)."""
    return bin(int(hex_a, 16) ^ int(hex_b, 16)).count("1")

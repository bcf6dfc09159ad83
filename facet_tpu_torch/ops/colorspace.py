"""Exact OpenCV-parity colour conversions on torch tensors.

Counterpart of ``facet_tpu/ops/colorspace.py``: cv2's 8-bit fixed-point
formulas in int32.

- gray = (R*9798 + G*19235 + B*3735 + 2^14) >> 15
- HSV  = the hsv_shift=12 formulation: S and H multiply by the reciprocal
  tables round((255<<12)/v) and round((180<<12)/(6d)), then descale with
  round-half-up.

The TPU package evaluated the reciprocals arithmetically (an f32 estimate
plus integer corrections) because gathers are slow on its vector unit; a
256-entry table gather is cheap on a GPU, so the port indexes cv2's tables,
built here with exact integer arithmetic: round(a/b) = (2a + b) // (2b).
"""

import numpy as np
import torch

_HSV_SHIFT = 12
_HALF = 1 << (_HSV_SHIFT - 1)


def _make_tables():
    idx = np.arange(256, dtype=np.int64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    a_s = 255 << _HSV_SHIFT
    a_h = 180 << _HSV_SHIFT
    sdiv[1:] = (2 * a_s + idx[1:]) // (2 * idx[1:])
    hdiv[1:] = (2 * a_h + 6 * idx[1:]) // (12 * idx[1:])
    return sdiv.astype(np.int32), hdiv.astype(np.int32)


SDIV_TABLE, HDIV_TABLE = _make_tables()
_tables = {}


def _table(device):
    key = str(device)
    if key not in _tables:
        _tables[key] = (torch.from_numpy(SDIV_TABLE).to(device),
                        torch.from_numpy(HDIV_TABLE).to(device))
    return _tables[key]


def _channels(rgb):
    x = rgb.to(torch.int32)
    return x[..., 0], x[..., 1], x[..., 2]


def rgb_to_gray(rgb):
    """uint8 RGB (..., 3) -> int32 gray (...) in [0, 255], exact cv2 parity."""
    r, g, b = _channels(rgb)
    return (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15


def rgb_to_hsv(rgb):
    """uint8 RGB (..., 3) -> (h, s, v) int32, exact cv2 8-bit parity.

    h in [0, 180), s and v in [0, 255].
    """
    r, g, b = _channels(rgb)
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    sdiv, hdiv = _table(rgb.device)
    # table[0] = 0, so v == 0 and diff == 0 need no special case
    s = (diff * sdiv[v.long()] + _HALF) >> _HSV_SHIFT
    h_num = torch.where(
        v == r, g - b,
        torch.where(v == g, (b - r) + 2 * diff, (r - g) + 4 * diff))
    h = (h_num * hdiv[diff.long()] + _HALF) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return h, s, v

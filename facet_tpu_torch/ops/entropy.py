"""H-S joint entropy: kernels 1 and 3 of the port.

``hs_entropy(hue, sat, stride=1)`` is the counterpart of
``facet_tpu/ops/pallas_entropy.py:hs_entropy_pallas_ilp`` (kernel 1): per
image, the 180x256 joint histogram of exact-cv2 hue (0..179) and saturation
(0..255) over every ``stride``-th pixel, and its Shannon entropy in bits,
normalized by the in-range count (a hue outside 0..179 lands in no bin).

``hs_entropy(hue, sat, n_valid=n)`` is the counterpart of
``pallas_entropy.py:hs_entropy_pallas`` (kernel 3): the same histogram with
the fixed denominator ``n``. That TPU kernel counts hue rows up to its
padded 192 while kernel 1 drops hue >= 180; the engine's hues are 0..179
and its markers -1 or 255, so the two agree on every input the engine
makes, and the port drops hue >= 180 in both.

On a CUDA tensor it launches the CUDA kernel in ``csrc/hs_entropy.cu``; on
a CPU tensor it computes the plain twin ``hs_entropy_plain``.
"""

import ctypes
import functools
import math

import torch

from facet_tpu_torch.ops import cuda_build

HUE_BINS = 180
SAT_BINS = 256
BINS = HUE_BINS * SAT_BINS
# pixels per block below which more slices only add histogram traffic
_MIN_SLICE_PIXELS = 16384


def _check(hue, sat, stride, n_valid=None):
    if hue.dim() != 2 or hue.shape != sat.shape:
        raise ValueError(f"hue/sat must be matching (B, N) planes, got "
                         f"{tuple(hue.shape)} and {tuple(sat.shape)}")
    if hue.dtype != torch.int32 or sat.dtype != torch.int32:
        raise TypeError(f"hue/sat must be int32, got {hue.dtype}/{sat.dtype}")
    if hue.device != sat.device:
        raise ValueError(f"hue on {hue.device} but sat on {sat.device}")
    if not (hue.is_contiguous() and sat.is_contiguous()):
        raise ValueError("hue/sat must be contiguous")
    if int(stride) != stride or stride < 1:
        raise ValueError(f"stride must be a positive int, got {stride!r}")
    if hue.shape[0] < 1 or hue.shape[1] < 1:
        raise ValueError(f"empty planes {tuple(hue.shape)}")
    if n_valid is not None and (int(n_valid) != n_valid or n_valid < 1):
        raise ValueError(f"n_valid must be a positive int or None, got {n_valid!r}")


def hs_histogram_plain(hue, sat, stride=1):
    """(B, 46080) int64 joint histogram of the in-range pixels (bincount)."""
    _check(hue, sat, stride)
    h = hue[:, ::stride].long()
    s = sat[:, ::stride].long()
    b = h.shape[0]
    valid = (h >= 0) & (h < HUE_BINS) & (s >= 0) & (s < SAT_BINS)
    offsets = torch.arange(b, device=h.device)[:, None] * BINS
    codes = torch.where(valid, h * SAT_BINS + s + offsets,
                        torch.full_like(h, b * BINS))
    hist = torch.bincount(codes.reshape(-1), minlength=b * BINS + 1)
    return hist[:b * BINS].view(b, BINS)


def entropy_from_histogram(hist, n_valid=None):
    """-sum p log2 p in float32, p = count * (1 / denominator): the in-range
    total, or n_valid when given; 0 for an image with no in-range pixel."""
    total = hist.sum(dim=1, keepdim=True)
    denom = total if n_valid is None else torch.full_like(total, int(n_valid))
    p = hist.to(torch.float32) * (1.0 / denom.to(torch.float32))
    logp = torch.log2(torch.where(p > 0, p, torch.ones_like(p)))
    entropy = -torch.sum(torch.where(p > 0, p * logp, torch.zeros_like(p)), dim=1)
    return torch.where(total[:, 0] > 0, entropy, torch.zeros_like(entropy))


def hs_entropy_plain(hue, sat, stride=1, n_valid=None):
    """Plain PyTorch twin: bincount histogram + the f32 entropy formula."""
    _check(hue, sat, stride, n_valid)
    return entropy_from_histogram(hs_histogram_plain(hue, sat, stride), n_valid)


def slices_for(batch, n_eff, sm_count):
    """Blocks per image: enough for ~2 blocks per SM over the batch, but no
    slice thinner than _MIN_SLICE_PIXELS pixels."""
    want = math.ceil(2 * sm_count / batch)
    return max(1, min(want, math.ceil(n_eff / _MIN_SLICE_PIXELS)))


@functools.lru_cache(maxsize=None)
def workspace_ints(batch, slices):
    """int32s of the histogram kernels' workspace (csrc/hs_reduce.cuh): the
    (batch, 46080) histograms first, then the reduce's shares and tickets
    and the histogram blocks' in-range counts."""
    ints = ctypes.c_longlong()
    cuda_build.check(cuda_build.library().facet_hs_workspace(
        batch, slices, ctypes.byref(ints)), "hs_workspace")
    return ints.value


def workspace(batch, slices, device):
    """An uninitialized workspace for ``batch`` images of ``slices``
    histogram blocks each (the kernels clear or write all of it they
    read)."""
    return torch.empty((workspace_ints(batch, slices),), dtype=torch.int32, device=device)


def _launch(hue, sat, stride, n_valid):
    """Launch the kernel -> ((B,) entropy, (B, 46080) int32 histogram)."""
    b, n = hue.shape
    if b > 65535:
        raise ValueError(f"hs_entropy: batch {b} exceeds the grid limit 65535")
    dev = hue.device
    slices = slices_for(b, -(-n // stride), cuda_build.sm_count(dev))
    ws = workspace(b, slices, dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    with cuda_build.on_device(dev):
        err = cuda_build.library().facet_hs_entropy(
            hue.data_ptr(), sat.data_ptr(), ws.data_ptr(), out.data_ptr(),
            b, n, int(stride), slices, int(n_valid or 0), cuda_build.stream(dev))
    cuda_build.check(err, "hs_entropy")
    if n_valid is None:
        hs_entropy.launches += 1               # kernel 1
    else:
        hs_entropy.launches_fixed += 1         # kernel 3
    return out, ws[:b * BINS].view(b, BINS)


def hs_entropy(hue, sat, stride=1, n_valid=None):
    """(B, N) int32 hue, (B, N) int32 saturation -> (B,) float32 bits;
    ``n_valid`` fixes the denominator (kernel 3), None normalizes by the
    in-range count (kernel 1)."""
    _check(hue, sat, stride, n_valid)
    if hue.device.type == "cpu":
        return hs_entropy_plain(hue, sat, stride, n_valid)
    if hue.device.type != "cuda":
        raise ValueError(f"hs_entropy: unsupported device {hue.device}")
    return _launch(hue, sat, stride, n_valid)[0]


def hs_entropy_with_histogram(hue, sat, stride=1):
    """-> (entropy, (B, 46080) int64 histogram): the kernel's histogram made
    visible, for checking it exactly against the twin on the card."""
    _check(hue, sat, stride)
    if hue.device.type == "cpu":
        hist = hs_histogram_plain(hue, sat, stride)
        return entropy_from_histogram(hist), hist
    if hue.device.type != "cuda":
        raise ValueError(f"hs_entropy: unsupported device {hue.device}")
    out, hist = _launch(hue, sat, stride, None)
    return out, hist.to(torch.int64)


hs_entropy.launches = 0          # kernel 1 (in-range denominator)
hs_entropy.launches_fixed = 0    # kernel 3 (n_valid given)

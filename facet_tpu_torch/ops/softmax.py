"""The ViT's row softmax: kernel 6 of the port.

``softmax(scores)`` is the counterpart of
``facet_tpu/ops/pallas_softmax.py:softmax_pallas``: the softmax over the
last axis of (B, H, Q, K) attention scores, computed in float32 inside (row
max, exp(s - max), row sum, division) and rounded once to the scores'
dtype. On a CUDA tensor it launches ``csrc/row_softmax.cu`` (bf16 only); on
a CPU tensor it computes the plain twin ``softmax_plain``. The engine runs
it with ``FACET_ATTN_IMPL=psoftmax`` (``models/clip.py``).
"""

import torch

from facet_tpu_torch.ops import cuda_build

MAX_COLS = 1024     # the kernel keeps a row in registers, up to 32 values a lane


def _check(scores):
    if scores.dim() != 4:
        raise ValueError(f"expected (B, H, Q, K) scores, got {tuple(scores.shape)}")
    if not scores.is_floating_point():
        raise TypeError(f"scores must be floating point, got {scores.dtype}")


def softmax_plain(scores):
    """Plain PyTorch twin, step by step after the TPU kernel's body."""
    _check(scores)
    s = scores.to(torch.float32)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return (e / e.sum(dim=-1, keepdim=True)).to(scores.dtype)


def softmax(scores):
    """(B, H, Q, K) scores -> row softmax over K, in the scores' dtype.

    The TPU kernel's ``head_block`` (heads per grid step) has no
    counterpart: the CUDA kernel walks groups of rows, a warp to a row.
    It runs once per ViT layer; its host path is cuda_build's (the device
    switched only when the scores lie on another card than the current one,
    the raw stream from torch's C binding).
    """
    _check(scores)
    if scores.device.type == "cpu":
        return softmax_plain(scores)
    if scores.device.type != "cuda":
        raise ValueError(f"softmax: unsupported device {scores.device}")
    if scores.dtype != torch.bfloat16:
        raise TypeError(f"the softmax kernel takes bfloat16 scores, got {scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    cols = scores.shape[-1]
    if cols > MAX_COLS:
        raise ValueError(f"the softmax kernel takes rows of up to {MAX_COLS}, got {cols}")
    out = torch.empty_like(scores)
    with cuda_build.on_device(scores.device):
        err = cuda_build.library().facet_row_softmax(
            scores.data_ptr(), out.data_ptr(), scores.numel() // cols, cols,
            cuda_build.stream(scores.device))
    cuda_build.check(err, "softmax")
    softmax.launches += 1
    return out


softmax.launches = 0

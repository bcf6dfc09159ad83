"""The ViT's fused self-attention: kernel 7 of the port.

``flash_attention(q, k, v, scale)`` is the counterpart of
``facet_tpu/models/clip.py:_flash_attention``, which runs JAX's Pallas TPU
flash-attention kernel. It keeps that function's layout: (B, S, H, D) q, k
and v in, (B, S, H, D) out, in their dtype. At the engine's schedule the
TPU kernel holds all keys in one block (the sequence padded to a multiple
of 128, the padding masked by segment ids), and its single-block body
computes: f32 scores from the unscaled q and k, times ``scale``; row max,
exp and row sum in f32; p / sum rounded to v's dtype; P V accumulated in
f32 and rounded once to the output dtype. On a CUDA tensor this launches
``csrc/vit_attention.cu`` (bf16, head dim 64, one block per (batch, head)
that stages the head's K and V once by TMA and runs wgmma; no padding in
device memory: the kernel excludes keys past S itself); on a CPU tensor it
computes the plain twin ``flash_attention_plain``. The engine runs it with
``FACET_ATTN_IMPL=flash`` (``models/clip.py``, which also refuses the TPU
block sizes that would split the keys into several blocks).
"""

import ctypes

import torch

from facet_tpu_torch.ops import cuda_build
from facet_tpu_torch.ops.precision import full_float32

KERNEL_HEAD_DIM = 64
MAX_SEQ = 400       # the kernel holds a head's keys and values in shared memory


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected (B, S, H, D) q, k, v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is {q.dtype} "
                             f"on {q.device}")
    if not q.is_floating_point():
        raise TypeError(f"q, k, v must be floating point, got {q.dtype}")


def flash_attention_plain(q, k, v, scale):
    """Plain PyTorch twin, line by line after the TPU kernel's single-block
    body, with full-float32 matmuls."""
    _check(q, k, v)
    qf, kf, vf = (t.transpose(1, 2).to(torch.float32) for t in (q, k, v))
    with full_float32():
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale     # (B, H, S, S)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = (p / l).to(v.dtype).to(torch.float32)
        out = torch.matmul(p, vf)
    return out.to(q.dtype).transpose(1, 2).contiguous()


def flash_attention(q, k, v, scale):
    """(B, S, H, D) q, k, v -> (B, S, H, D) softmax(q k^T * scale) v."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, s, h, d = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bfloat16, got {q.dtype}")
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"the attention kernel takes head dim {KERNEL_HEAD_DIM}, "
                         f"got {d}")
    if s > MAX_SEQ:
        raise ValueError(f"the attention kernel takes up to {MAX_SEQ} tokens, got {s}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    with cuda_build.on_device(q.device):
        err = cuda_build.library().facet_vit_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
            float(scale), cuda_build.stream(q.device))
    cuda_build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def geometry(b, s, h):
    """The kernel's grid at (b, s, h), as csrc/vit_attention.cu reckons it
    from its tiling (a card is needed): blocks, blocks resident per SM,
    bytes staged into shared memory."""
    blocks, per_sm, staged = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
    cuda_build.check(cuda_build.library().facet_vit_attention_geometry(
        b, s, h, ctypes.byref(blocks), ctypes.byref(per_sm), ctypes.byref(staged)),
        "flash_attention geometry")
    return {"blocks": blocks.value, "blocks_per_sm": per_sm.value,
            "staged_bytes": staged.value}

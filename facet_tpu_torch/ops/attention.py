"""TOPIQ's cross-attention: kernel 2 of the port.

``cross_attention(q, k, v)`` is the counterpart of
``facet_tpu/ops/pallas_attn.py:cross_attention_pallas``: softmax(Q K^T) V
for (B, H, Nq, D) pre-scaled queries over (B, H, Nk, D) keys/values, with
bf16 operands, f32 scores and softmax, p normalized then rounded to bf16,
and f32 accumulation of P V. On a CUDA tensor it launches the CUDA kernel in
``csrc/cross_attention.cu`` (head dim 64: a prologue that converts K and V
to bf16 into scratch the wrapper allocates, then two passes of wgmma over
TMA-staged tiles); on a CPU tensor it computes the plain twin
``cross_attention_plain``. ``supported_shape`` is the JAX
package's gate, unchanged, so both packages route the same levels.
"""

import ctypes

import torch

from facet_tpu_torch.ops import cuda_build
from facet_tpu_torch.ops.precision import full_float32

DEFAULT_Q_BLOCK = 512
KERNEL_HEAD_DIM = 64


def supported_shape(nq, nk, q_block=None):
    """The kernel's applicability gate (facet_tpu/ops/pallas_attn.py:83).

    Q must tile into q_block steps with at least two of them; K must be a
    multiple of 128 (no softmax mask is implemented).
    """
    if q_block is None:
        q_block = DEFAULT_Q_BLOCK
    return nq % q_block == 0 and nq // q_block >= 2 and nk % 128 == 0


def _check(q, k, v, q_block):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected (B, H, Q, D) q and matching (B, H, K, D) "
                         f"k/v, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         f"on batch, heads or head dim")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device} but q on {q.device}")
    if not supported_shape(q.shape[2], k.shape[2], q_block):
        raise ValueError(f"unsupported attention shape q={tuple(q.shape)} "
                         f"k={tuple(k.shape)}")


def cross_attention_plain(q, k, v, q_block=None):
    """Plain PyTorch twin, line by line after the TPU kernel's body, with
    full-float32 matmuls."""
    _check(q, k, v, q_block)
    qb = q.to(torch.bfloat16).to(torch.float32)
    kb = k.to(torch.bfloat16).to(torch.float32)
    vb = v.to(torch.bfloat16).to(torch.float32)
    with full_float32():
        s = torch.matmul(qb, kb.transpose(-1, -2))             # (B, H, Q, K) f32
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16).to(torch.float32)
        return torch.matmul(p, vb)


def cross_attention(q, k, v, q_block=None):
    """(B, H, Q, D) f32 query x (B, H, K, D) f32 key/value -> (B, H, Q, D)."""
    _check(q, k, v, q_block)
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, q_block)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention: unsupported device {q.device}")
    b, h, nq, d = q.shape
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"cross_attention kernel takes head dim "
                         f"{KERNEL_HEAD_DIM}, got {d}")
    nk = k.shape[2]
    out = torch.empty_like(q)
    scratch = torch.empty((2, b * h * nk, d), dtype=torch.bfloat16, device=q.device)
    with cuda_build.on_device(q.device):
        err = cuda_build.library().facet_cross_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            b * h, nq, nk, d, cuda_build.stream(q.device))
    cuda_build.check(err, "cross_attention")
    cross_attention.launches += 1
    return out


cross_attention.launches = 0


def geometry(b, h, nq, nk):
    """The kernel's grid at (b, h, nq, nk), as csrc/cross_attention.cu
    reckons it from its tiling (a card is needed): blocks, blocks resident
    per SM, bytes staged into shared memory, bytes of K and V read through
    L2."""
    blocks, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    staged, l2 = ctypes.c_longlong(0), ctypes.c_longlong(0)
    cuda_build.check(cuda_build.library().facet_cross_attention_geometry(
        b * h, nq, nk, ctypes.byref(blocks), ctypes.byref(per_sm), ctypes.byref(staged),
        ctypes.byref(l2)), "cross_attention geometry")
    return {"blocks": blocks.value, "blocks_per_sm": per_sm.value,
            "staged_bytes": staged.value, "l2_bytes": l2.value}

"""Full float32 for the port's float32 device work.

PyTorch lets cuDNN run float32 convolutions in TF32 (a 10-bit mantissa) by
default, and ``torch.set_float32_matmul_precision`` can do the same to
matmuls. The JAX package computes TOPIQ, the resize matrices and the plain
attention twin in full float32, so the layers that own that work run under
``full_float32()``: TF32 off for cuDNN and cuBLAS inside the block, and the
caller's settings restored after it. ``tf32_matmul()`` is the one place
that turns TF32 on, for float32 matmuls whose inputs hold bf16 values.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_precision = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul_precision)


@contextlib.contextmanager
def tf32_matmul(enabled=True):
    """TF32 for float32 matmuls inside the block, when ``enabled``: only for
    inputs that hold bfloat16 values (the text decoder's scores and P V over
    its float32 cache), where TF32's 10-bit input rounding changes no value
    and the products are exact in the float32 accumulator."""
    if not enabled:
        yield
        return
    matmul_precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul_precision)

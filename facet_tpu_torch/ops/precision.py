"""Full float32 for the port's float32 device work.

PyTorch lets cuDNN run float32 convolutions in TF32 (a 10-bit mantissa) by
default, and ``torch.set_float32_matmul_precision`` can do the same to
matmuls. The JAX package computes TOPIQ, the resize matrices and the plain
attention twin in full float32, so the layers that own that work run under
``full_float32()``: TF32 off for cuDNN and cuBLAS inside the block, and the
caller's settings restored after it.
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

"""The reference's precision: float32 with TF32 off, or, for the control,
float32 products in TF32.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits; a TF32
product rounds its operands to it and accumulates in float32.  Setting
the TF32 flags leaves most of this workload's products alone (cuBLAS and
cuDNN keep small batched products and these convolutions on their
float32 kernels), so the control also rounds the operands of every
matrix product, ``einsum`` and convolution itself, as TF32 hardware
would."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def to_tf32(t):
    """A float32 tensor rounded to TF32's 11 significant bits (to
    nearest, by Veltkamp's split); anything else unchanged."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        return t
    c = t * 8193.0                      # 2**(24 - 11) + 1
    return c - (c - t)


@contextlib.contextmanager
def _tf32_products():
    matmul, einsum, dunder, conv2d = (torch.matmul, torch.einsum, torch.Tensor.__matmul__,
                                      F.conv2d)

    def tf_matmul(a, b, **kw):
        return matmul(to_tf32(a), to_tf32(b), **kw)

    def tf_einsum(eq, *ops):
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        return einsum(eq, *[to_tf32(o) for o in ops])

    def tf_dunder(a, b):
        return matmul(to_tf32(a), to_tf32(b))

    def tf_conv2d(x, w, *a, **kw):
        return conv2d(to_tf32(x), to_tf32(w), *a, **kw)

    torch.matmul, torch.einsum, torch.Tensor.__matmul__, F.conv2d = (
        tf_matmul, tf_einsum, tf_dunder, tf_conv2d)
    try:
        yield
    finally:
        torch.matmul, torch.einsum, torch.Tensor.__matmul__, F.conv2d = (
            matmul, einsum, dunder, conv2d)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 off inside the block, or, with ``tf32``, the TF32 flags on
    and every product's operands rounded to TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        if tf32:
            with _tf32_products():
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

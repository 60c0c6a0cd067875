"""The arithmetic of the plain reference: float32 products, or a lower
precision for the control.

Every product of the reference goes through :func:`matmul`. In "float32" it
is a plain float32 product with TF32 switched off (:func:`exact_float32`).
The controls round both operands of every product to a lower format first,
and the gradient's operands too, then multiply in float32, as a tensor core
that takes the format and accumulates in float32 does:

* "tf32": 10 explicit mantissa bits, round to nearest (the step below
  float32 with TF32 off);
* "bf16": bfloat16 operands, as a bfloat16 configuration states its
  products (a yardstick of how far that rounding alone moves a result);
* "fp8": float8 e4m3 with one scale per operand (its largest magnitude to
  448), the step below bfloat16.

The rounding is written out, so a control reads the same on the CPU and on
the card.
"""

from __future__ import annotations

import contextlib

import torch

FORMATS = ("float32", "tf32", "bf16", "fp8")


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN inside the block, as it was after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_to(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """float32 ``x`` rounded to ``fmt`` and back to float32."""
    if fmt == "float32":
        return x
    if fmt == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if fmt == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"unknown format {fmt!r}")


class _LowMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fmt):
        ra, rb = round_to(a, fmt), round_to(b, fmt)
        ctx.save_for_backward(ra, rb)
        ctx.fmt = fmt
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        g = round_to(g.contiguous(), ctx.fmt)
        return g @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ g, None


def matmul(a: torch.Tensor, b: torch.Tensor, fmt: str = "float32"):
    """``a @ b`` in ``fmt`` (float32 operands of one shape of batch: two
    matrices, or two stacks of them)."""
    if fmt == "float32":
        return a @ b
    return _LowMatmul.apply(a, b, fmt)


def linear(x, weight, bias=None, fmt: str = "float32"):
    """``x W^T + b`` in ``fmt``, over the last axis of ``x``."""
    y = matmul(x.reshape(-1, x.shape[-1]), weight.t(), fmt)
    y = y.reshape(*x.shape[:-1], weight.shape[0])
    return y if bias is None else y + bias

"""Triton kernels of the fused decode-tick epilogue's two norms (see
``tick_fusion``; its rope is CUDA C++, ``csrc/rope.cu``).

This module imports ``triton`` at its top, so only the launching wrappers
in ``tick_fusion`` import it, inside the call that launches a kernel.

Rounding follows the JAX reference: the mean square is fp32, the normed
value is rounded to the tensor's dtype, then multiplied by the gain in
that dtype. A product of two bf16 values is exact in fp32, so computing it
in fp32 and rounding once gives the bf16 product.
"""

import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def rms_kernel(x_ptr, w_ptr, o_ptr, H, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < H
    x = tl.load(x_ptr + row * H + cols, mask=mask, other=0.0)
    xf = x.to(tl.float32)
    var = tl.sum(xf * xf, axis=0) / H
    normed = (xf * libdevice.rsqrt(var + eps)).to(x.dtype)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0)
    out = normed.to(tl.float32) * w.to(tl.float32)
    tl.store(o_ptr + row * H + cols, out.to(x.dtype), mask=mask)


@triton.jit
def add_rms_kernel(x_ptr, y_ptr, w_ptr, s_ptr, o_ptr, H, eps,
                   BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < H
    x = tl.load(x_ptr + row * H + cols, mask=mask, other=0.0)
    y = tl.load(y_ptr + row * H + cols, mask=mask, other=0.0)
    s = (x.to(tl.float32) + y.to(tl.float32)).to(x.dtype)
    tl.store(s_ptr + row * H + cols, s, mask=mask)
    sf = s.to(tl.float32)
    var = tl.sum(sf * sf, axis=0) / H
    normed = (sf * libdevice.rsqrt(var + eps)).to(x.dtype)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0)
    out = normed.to(tl.float32) * w.to(tl.float32)
    tl.store(o_ptr + row * H + cols, out.to(x.dtype), mask=mask)

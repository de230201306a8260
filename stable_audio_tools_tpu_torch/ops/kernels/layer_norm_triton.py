"""Triton source of `fused_layer_norm` (see layer_norm.py for its note).

Imported only by the launching function: importing it needs `triton`."""

import triton
import triton.language as tl


@triton.jit
def ln_fwd(x_ptr, g_ptr, b_ptr, y_ptr, C, eps,
           HAS_BETA: tl.constexpr, BLOCK: tl.constexpr):
    """One program per row of x [R, C]: f32 two-pass statistics, y in x's dtype."""
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < C
    x = tl.load(x_ptr + row * C + cols, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / C
    xc = tl.where(mask, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / C
    y = xc * (1.0 / tl.sqrt(var + eps))
    y = y * tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    if HAS_BETA:
        y = y + tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(y_ptr + row * C + cols, y.to(y_ptr.dtype.element_ty), mask=mask)

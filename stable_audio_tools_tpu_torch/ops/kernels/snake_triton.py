"""Triton source of `snake_fused` (see snake.py for its note).

Imported only by the launching function: importing it needs `triton`."""

import triton
import triton.language as tl


@triton.jit
def snake_fwd(x_ptr, a_ptr, b_ptr, y_ptr, C, L, BLOCK: tl.constexpr):
    """x, y: [B, C, L]; one program per (b*C + c, block of L). f32 math,
    exact sin (libdevice sinf), y in x's dtype."""
    row = tl.program_id(0)
    c = row % C
    cols = tl.program_id(1).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = cols < L
    base = row.to(tl.int64) * L
    a = tl.load(a_ptr + c)
    binv = 1.0 / (tl.load(b_ptr + c) + 1e-9)
    x = tl.load(x_ptr + base + cols, mask=mask, other=0.0).to(tl.float32)
    s = tl.sin(a * x)
    tl.store(y_ptr + base + cols, (x + s * s * binv).to(y_ptr.dtype.element_ty),
             mask=mask)

"""Triton sources of `snake_fused` and its backward (see snake.py for their
notes).

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


@triton.jit
def snake_bwd(x_ptr, g_ptr, a_ptr, b_ptr, dx_ptr, pa_ptr, pb_ptr, C, L, NBLK,
              BLOCK: tl.constexpr):
    """x, g, dx: [B, C, L]; pa, pb: [B*C, NBLK] f32 partial sums of dalpha,
    dbeta, one per program (b*C + c, block of L). Exact sin/cos in f32;
    lanes past L are excluded with `where`, not a product with 0."""
    row = tl.program_id(0)
    blk = tl.program_id(1)
    c = row % C
    cols = blk.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = cols < L
    base = row.to(tl.int64) * L
    a = tl.load(a_ptr + c)
    binv = 1.0 / (tl.load(b_ptr + c) + 1e-9)
    x = tl.load(x_ptr + base + cols, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + base + cols, mask=mask, other=0.0).to(tl.float32)
    s = tl.sin(a * x)
    ds2 = 2.0 * s * tl.cos(a * x)  # d sin^2(a x) / d(a x) = sin(2 a x)
    tl.store(dx_ptr + base + cols, (g * (1.0 + a * binv * ds2)).to(dx_ptr.dtype.element_ty),
             mask=mask)
    pa = tl.where(mask, g * x * binv * ds2, 0.0)
    pb = tl.where(mask, -g * s * s * binv * binv, 0.0)
    out = row.to(tl.int64) * NBLK + blk
    tl.store(pa_ptr + out, tl.sum(pa, axis=0))
    tl.store(pb_ptr + out, tl.sum(pb, axis=0))

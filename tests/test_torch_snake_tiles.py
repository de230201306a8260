"""The snake activation's work plan on Hopper (`csrc/snake.cu`, rows 4 and 9),
rehearsed in numpy on the CPU and held against the JAX package.

`emulate_bwd` walks the backward kernel's schedule from the wrapper's own
plan (`snake.snake_plan`): blocks of `THREADS` threads, `tpr` threads along a
row and THREADS // tpr rows a pass, `col_steps` vectors of `vec` elements a
thread `tpr * vec` apart, `row_passes` passes, `ncb` column blocks; each
thread's f32 partials summed in the kernel's order (its vectors in turn),
then over the row's lanes by the kernel's xor-shuffle tree and over the row's
warps in order, into a workspace [2, B*C, ncb]; the second stage sums each
channel's B * ncb slots as the kernel does (lane l takes terms l, l + 32, ...
in order, then the shuffle tree) and scales them by 2 binv and -binv^2. It
counts every read of x and g, every write of dx and every workspace slot:
each exactly once. `emulate_fwd` walks the forward's schedule the same way.

Each case takes the plan of a main-path site (the SA-2.0 VAE's 6 snake sites
at batch 4, its decode group's 5 at batch 8) or of a ragged shape, and runs
it over few rows of the site's length (the plan's walk along a row and its
stacking of rows do not depend on how many rows there are), so the numerics
stay small; the full site's plan is checked for its tile and grid.

Tolerances, of each output's peak: 1e-5 against the port's plain versions
and the JAX `snake_beta` (its CPU path, exact `jnp.sin`; `jax.vjp` for the
backward): f32 both sides, other summation orders. 1e-4 against the JAX
Pallas kernels `_bwd` / `_fwd` in interpret mode, whose sin^2 and its
derivative are a range-reduced polynomial (as tests/test_torch_ae_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops.activations import snake_beta as jax_snake_beta
from stable_audio_tools_tpu.ops.kernels import snake as jsn
from stable_audio_tools_tpu_torch.ops.kernels import snake as tsn

TOL = 1e-5
PALLAS_TOL = 1e-4
THREADS = tsn.THREADS
F32 = np.float32

# (B, C, L): the SA-2.0 VAE's snake_fused sites at batch 4 (encoder before
# each strided conv, decoder before each transposed one), its decode group's
# at batch 8, and ragged shapes (L off the vector, one element, a row that
# needs several column blocks)
AE_SITES = [(4, 128, 65536), (4, 128, 32768), (4, 256, 8192), (4, 512, 2048), (4, 1024, 256),
            (4, 2048, 32)]
DECODE_SITES = [(8, 2048, 128), (8, 1024, 1024), (8, 512, 8192), (8, 256, 32768),
                (8, 128, 131072)]
RAGGED = [(2, 33, 5000), (3, 7, 100), (1, 1, 1), (2, 48, 700)]
CASES = AE_SITES + DECODE_SITES + RAGGED


def _cdiv(a, b):
    return -(-a // b)


def _small(B, C, plan):
    """(B', C') of few rows: more than one row block where the plan stacks
    rows, the last one partial; up to 8 channels, so that a gradient's peak
    is not one channel's sum, which may cancel to near 0."""
    return min(B, 2), min(C, max(8, plan.rows // 2 + 1))


def _threads(plan):
    t = np.arange(THREADS)
    return t, t // plan.tpr, t % plan.tpr


def _walk(plan, rows, L):
    """Yield (row block, column block, pass, each thread's row [THREADS],
    [(each thread's first column, live) for each of its vectors]) in the
    kernel's order."""
    _, sub, lane = _threads(plan)
    rows_pass, step = THREADS // plan.tpr, plan.tpr * plan.vec
    for rb in range(_cdiv(rows, plan.rows)):
        for cb in range(plan.ncb):
            for p in range(plan.row_passes):
                row = (rb * plan.row_passes + p) * rows_pass + sub
                steps = []
                for s in range(plan.col_steps):
                    col = cb * plan.cols + lane * plan.vec + s * step
                    # a vector is live whole (L is a multiple of it) or not at all
                    steps.append((col, (row < rows) & (col < L)))
                yield rb, cb, p, row, steps


def _xor_tree(v, width):
    """Lane values after the kernel's xor-shuffle sum over groups of
    `width` lanes (each lane ends with its group's sum, in its own order)."""
    idx = np.arange(v.shape[0])
    off = width // 2
    while off:
        v = (v + v[idx ^ off]).astype(F32)
        off //= 2
    return v


def emulate_bwd(x, g, alpha, beta, plan):
    """(dx, dalpha, dbeta) of x, g [B, C, L] f32 by the backward's schedule;
    asserts every element read once and written once, every slot once."""
    B, C, L = x.shape
    rows = B * C
    X, G = x.reshape(rows, L), g.reshape(rows, L)
    a = alpha.astype(F32)
    binv = (F32(1) / (beta.astype(F32) + F32(1e-9))).astype(F32)
    ab2 = (F32(2) * a * binv).astype(F32)
    reads = np.zeros((rows, L), np.int32)
    dx = np.zeros((rows, L), F32)
    dx_writes = np.zeros((rows, L), np.int32)
    ws = np.zeros((2, rows, plan.ncb), F32)
    ws_writes = np.zeros((rows, plan.ncb), np.int32)
    t, _, lane = _threads(plan)
    rows_pass = THREADS // plan.tpr
    for rb, cb, p, row, steps in _walk(plan, rows, L):
        sa, sb = np.zeros(THREADS, F32), np.zeros(THREADS, F32)
        for col, live in steps:
            r = row[live]
            ch = r % C
            for u in range(plan.vec):
                c = col[live] + u
                reads[r, c] += 1
                xv, gv = X[r, c], G[r, c]
                arg = (a[ch] * xv).astype(F32)
                sn, cs = np.sin(arg).astype(F32), np.cos(arg).astype(F32)
                gsc = (gv * (sn * cs)).astype(F32)
                dx[r, c] = ab2[ch] * gsc + gv
                dx_writes[r, c] += 1
                sa[live] = (sa[live] + gsc * xv).astype(F32)
                sb[live] = (sb[live] + gv * (sn * sn)).astype(F32)
        sa, sb = _xor_tree(sa, min(plan.tpr, 32)), _xor_tree(sb, min(plan.tpr, 32))
        if plan.tpr <= 32:
            lead = (lane == 0) & (row < rows)
            ws[0, row[lead], cb], ws[1, row[lead], cb] = sa[lead], sb[lead]
            ws_writes[row[lead], cb] += 1
            continue
        wpr = plan.tpr // 32
        warp_a, warp_b = sa[t % 32 == 0], sb[t % 32 == 0]
        for i in range(rows_pass):
            r = (rb * plan.row_passes + p) * rows_pass + i
            if r < rows:
                ta, tb = F32(0), F32(0)
                for k in range(wpr):
                    ta, tb = F32(ta + warp_a[i * wpr + k]), F32(tb + warp_b[i * wpr + k])
                ws[0, r, cb], ws[1, r, cb] = ta, tb
                ws_writes[r, cb] += 1
    assert (reads == 1).all() and (dx_writes == 1).all() and (ws_writes == 1).all()
    sums = np.zeros((2, C), F32)
    for c in range(C):
        terms = ws[:, [b * C + c for b in range(B)], :].reshape(2, -1)  # order (b, cb)
        lanes = np.zeros((2, 32), F32)
        for i in range(terms.shape[1]):
            lanes[:, i % 32] = (lanes[:, i % 32] + terms[:, i]).astype(F32)
        sums[0, c], sums[1, c] = _xor_tree(lanes[0], 32)[0], _xor_tree(lanes[1], 32)[0]
    dalpha = (F32(2) * binv * sums[0]).astype(F32)
    dbeta = (-(binv * binv) * sums[1]).astype(F32)
    return dx.reshape(B, C, L), dalpha, dbeta


def emulate_fwd(x, alpha, beta, plan):
    """y of x [B, C, L] f32 by the forward's schedule (snake_math.cuh's
    `snake_n`: v + (s * s) * binv, no contraction); every element read and
    written once."""
    B, C, L = x.shape
    rows = B * C
    X = x.reshape(rows, L)
    binv = (F32(1) / (beta.astype(F32) + F32(1e-9))).astype(F32)
    y = np.zeros((rows, L), F32)
    count = np.zeros((rows, L), np.int32)
    for _, _, _, row, steps in _walk(plan, rows, L):
        for col, live in steps:
            r = row[live]
            for u in range(plan.vec):
                c = col[live] + u
                s = np.sin((alpha[r % C].astype(F32) * X[r, c]).astype(F32)).astype(F32)
                y[r, c] = X[r, c] + (s * s) * binv[r % C]
                count[r, c] += 1
    assert (count == 1).all()
    return y.reshape(B, C, L)


def _inputs(B, C, L, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, C, L)) * 2).astype(F32)
    g = rng.standard_normal((B, C, L)).astype(F32)
    alpha = np.exp(rng.standard_normal(C) * 0.5).astype(F32)
    beta = np.exp(rng.standard_normal(C) * 0.5).astype(F32)
    return x, g, alpha, beta


def _close(got, want, rel):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               atol=rel * max(np.abs(want).max(), 1e-6), rtol=0)


def _blc(t):
    return jnp.asarray(np.ascontiguousarray(t.transpose(0, 2, 1)))


@pytest.mark.parametrize("B,C,L", CASES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_tiles_and_grid(B, C, L, itemsize):
    # the full site's plan: vectors where L allows, a power of two of threads
    # along a row, a tile within the block's budget (at least one vector a
    # thread, at most BLOCK_ELEMS), rows stacked only where a row is short,
    # and the grid covering B*C rows by L columns
    p = tsn.snake_plan(B, C, L, itemsize)
    vec = 16 // itemsize
    assert p.vec == (vec if L % vec == 0 else 1)
    assert p.tpr & (p.tpr - 1) == 0 and p.tpr <= THREADS
    assert p.tpr * p.vec >= min(L, THREADS * p.vec) or p.tpr == THREADS
    assert THREADS * p.vec <= p.rows * p.cols <= max(tsn.BLOCK_ELEMS, THREADS * p.vec)
    assert p.rows == THREADS // p.tpr * p.row_passes and p.cols == p.col_steps * p.tpr * p.vec
    assert p.row_passes == 1 or p.cols >= L  # rows stacked only where one block holds a row
    assert p.ncb == _cdiv(L, p.cols) and (p.ncb - 1) * p.cols < L
    assert p.blocks == _cdiv(B * C, p.rows) * p.ncb
    if (B, C, L) not in RAGGED:  # no block of dead lanes on the main path
        assert B * C * L == p.blocks * p.rows * p.cols
    assert tsn.snake_plan(B, C, L, itemsize, False).vec == 1


@pytest.mark.parametrize("B,C,L", CASES)
def test_emulated_bwd_matches_plain_and_jax(B, C, L):
    plan = tsn.snake_plan(B, C, L, 2)  # the bf16 main path's plan
    Bs, Cs = _small(B, C, plan)
    x, g, alpha, beta = _inputs(Bs, Cs, L, seed=B * C + L)
    dx, da, db = emulate_bwd(x, g, alpha, beta, plan)
    want = tsn.snake_fused_bwd_plain(*(torch.from_numpy(v) for v in (x, alpha, beta, g)))
    for got, ref in zip((dx, da, db), want):
        _close(got, ref.numpy(), TOL)
    _, pull = jax.vjp(jax_snake_beta, _blc(x), jnp.asarray(alpha), jnp.asarray(beta))
    jdx, jda, jdb = pull(_blc(g))
    _close(dx, np.asarray(jdx).transpose(0, 2, 1), TOL)
    _close(da, jda, TOL)
    _close(db, jdb, TOL)
    pdx, pda, pdb = jsn._bwd(_blc(x), jnp.asarray(alpha), jnp.asarray(beta), _blc(g))
    _close(dx, np.asarray(pdx).transpose(0, 2, 1), PALLAS_TOL)
    _close(da, pda, PALLAS_TOL)
    _close(db, pdb, PALLAS_TOL)


@pytest.mark.parametrize("B,C,L", CASES)
def test_emulated_fwd_matches_plain_and_jax(B, C, L):
    plan = tsn.snake_plan(B, C, L, 2)
    Bs, Cs = _small(B, C, plan)
    x, _, alpha, beta = _inputs(Bs, Cs, L, seed=B * C + L + 1)
    y = emulate_fwd(x, alpha, beta, plan)
    _close(y, tsn.snake_fused_plain(*(torch.from_numpy(v) for v in (x, alpha, beta))).numpy(),
           TOL)
    want = jax_snake_beta(_blc(x), jnp.asarray(alpha), jnp.asarray(beta))
    _close(y, np.asarray(want).transpose(0, 2, 1), TOL)
    want = jsn._fwd(_blc(x), jnp.asarray(alpha), jnp.asarray(beta))
    _close(y, np.asarray(want).transpose(0, 2, 1), PALLAS_TOL)


# (B, C, L): the snake sites of both DAC VAE-GANs' generator steps at batch 4
# x 65,536 (the encoders' before each strided conv, the decoders' before
# each transposed one), DAC's snake: beta is alpha
DAC_SITES = [(4, 128, 65536), (4, 256, 16384), (4, 512, 4096), (4, 1024, 512), (4, 1536, 64),
             (4, 768, 512), (4, 384, 4096), (4, 192, 16384), (4, 512, 2048), (4, 1024, 256),
             (4, 1536, 32), (4, 768, 256), (4, 384, 2048)]


@pytest.mark.parametrize("B,C,L", DAC_SITES)
def test_emulated_bwd_with_beta_tied_to_alpha(B, C, L):
    # models/dac.py passes one alpha as both parameters; the kernel's dalpha
    # and dbeta, summed as autograd sums them into the one parameter, are the
    # JAX gradient of x + sin^2(alpha x) / (alpha + 1e-9) with respect to
    # alpha, and dx its gradient with respect to x
    plan = tsn.snake_plan(B, C, L, 2)
    Bs, Cs = _small(B, C, plan)
    x, g, alpha, _ = _inputs(Bs, Cs, L, seed=B * C + L + 2)
    dx, da, db = emulate_bwd(x, g, alpha, alpha, plan)
    want = tsn.snake_fused_bwd_plain(*(torch.from_numpy(v) for v in (x, alpha, alpha, g)))
    for got, ref in zip((dx, da, db), want):
        _close(got, ref.numpy(), TOL)

    def dac_snake(x, a):
        return x + jnp.sin(a * x) ** 2 / (a + 1e-9)

    _, pull = jax.vjp(dac_snake, _blc(x), jnp.asarray(alpha))
    jdx, jda = pull(_blc(g))
    _close(dx, np.asarray(jdx).transpose(0, 2, 1), TOL)
    _close(da + db, jda, TOL)


@pytest.mark.parametrize("B,C,L,itemsize,vector", [(2, 33, 5000, 4, True), (2, 48, 700, 2, False),
                                                  (2, 5, 4096, 2, False), (3, 7, 100, 4, True)])
def test_emulated_bwd_other_plans(B, C, L, itemsize, vector):
    # f32 vectors (4 a thread), and the one-element path a misaligned view
    # takes, against the plain version
    plan = tsn.snake_plan(B, C, L, itemsize, vector)
    x, g, alpha, beta = _inputs(B, C, L, seed=L)
    got = emulate_bwd(x, g, alpha, beta, plan)
    want = tsn.snake_fused_bwd_plain(*(torch.from_numpy(v) for v in (x, alpha, beta, g)))
    for p, q in zip(got, want):
        _close(p, q.numpy(), TOL)


def test_snake_fused_routes_on_the_cpu():
    # with grad on and an input that requires it, the autograd Function (its
    # backward the plain version); otherwise the plain forward, no node
    x, g, alpha, beta = (torch.from_numpy(v) for v in _inputs(2, 3, 50, seed=3))
    xr = x.clone().requires_grad_()
    y = tsn.snake_fused(xr, alpha, beta)
    assert y.grad_fn is not None
    (dx,) = torch.autograd.grad((y * g).sum(), xr)
    torch.testing.assert_close(dx, tsn.snake_fused_bwd_plain(x, alpha, beta, g)[0])
    with torch.no_grad():
        assert tsn.snake_fused(xr, alpha, beta).grad_fn is None
    y0 = tsn.snake_fused(x, alpha, beta)
    assert y0.grad_fn is None and torch.equal(y0, y.detach())

"""The snake-conv forward's index plan on Hopper (`csrc/snake_conv1d.cu`:
rows 3 and 12), rehearsed in numpy on the CPU and held against the JAX
package.

`emulate` walks the kernels' schedule from the wrapper's own tile constants
(`conv1d_snake.CI_CHUNK`, `tile_n`, `block_tile`): blocks of one batch row
and one output-channel tile (the Co tile padded to N: Co = 2 -> n8), strips
of S output tiles, per tile the chunks of 64 input channels, each channel's
bulk copy of the window's input times widened to 16 bytes at both ends (from
a flat x whose first element may lie off a 16-byte boundary), the snake'd
window with padding rows exactly 0, the carry of the last (k-1)*d window
rows from one tile of a strip to the next, the k taps as products of the
window shifted by j*d rows with the tap's weight slice per consumer
warpgroup (two 128-row halves, or two 128-channel halves for Co > 128), and
the epilogue (bias, the residual of row 3, the ragged last tile cut).

Seeded f32 inputs go through the emulation, the JAX package's
`snake_conv1d` / `snake_conv1d_res` (the Pallas kernels in interpret mode,
as tests/test_torch_snake_carry.py runs them) and the port's plain version.
Tolerance: 1e-5 of the output's peak against the plain version (f32 on both
sides, other summation orders) and against the JAX package (whose snake is a
polynomial sin^2, error < 1e-9 before the products); with and without the
carry the emulation gives the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops.kernels import conv1d_snake as jcs
from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as tcs

TOL = 1e-5
PAD = 16  # NaN guard elements around the flat x: a copy never reaches past them


def _snake(v, a, binv):
    s = np.sin(a * v)
    return v + s * s * binv


def _copy_row(xpad, base_off, lo, hi):
    """The bulk copy of flat elements [lo, hi) of x (element 0 at byte
    base_off): from lo's 16-byte boundary to the one at or after hi. Returns
    the staged row and where element lo lies in it."""
    p0, p1 = base_off + 2 * lo, base_off + 2 * hi
    src, end = p0 & ~15, (p1 + 15) & ~15
    e0, e1 = (src - base_off) // 2, (end - base_off) // 2
    return xpad[PAD + e0:PAD + e1], (p0 & 15) // 2


def emulate(x, w, bias, alpha, beta, pad_lo, pad_hi, d, res=None, strip=1, carry=False,
            base_off=0):
    """y of the kernels' schedule, in f32. x [B, Ci, L], w [Co, Ci, k]."""
    B, Ci, L = x.shape
    Co, _, k = w.shape
    CIC = tcs.CI_CHUNK
    nt, split = tcs.tile_n(Co)
    BM, NB = tcs.block_tile(Co)
    span = (k - 1) * d
    assert span <= tcs.MAX_SPAN
    rows, Lout = BM + span, L + pad_lo + pad_hi - span
    nch = -(-Ci // CIC)
    # the wrapper's weights: [k, Co, Ci_pad], input channels zero-padded
    wp = np.zeros((k, Co, nch * CIC), np.float32)
    wp[:, :, :Ci] = w.transpose(2, 0, 1)
    binv = 1.0 / (beta + 1e-9)
    nan = np.full(PAD, np.nan, np.float32)
    xpad = np.concatenate([nan, x.reshape(-1), nan])
    y = np.full((B, Co, Lout), np.nan, np.float32)
    tiles = -(-Lout // BM)
    for b in range(B):
        for n0 in range(0, Co, NB):
            # the tap's [NB][64] slice as the TMA lands it: rows past Co are 0
            wslab = np.zeros((k, NB, nch * CIC), np.float32)
            wslab[:, :min(NB, Co - n0)] = wp[:, n0:n0 + NB]
            for t0 in range(0, tiles, strip):
                t1 = min(t0 + strip, tiles)
                kept = {}
                for tile in range(t0, t1):
                    lbase = tile * BM - pad_lo  # input time of window row 0
                    r_lo = span if carry and tile > t0 else 0
                    lo, hi = max(lbase + r_lo, 0), min(lbase + rows, L)
                    acc = np.zeros((BM, NB), np.float32)
                    for c in range(nch):
                        win = np.zeros((rows, CIC), np.float32)
                        if r_lo:
                            win[:span] = kept[c]
                        for ch in range(CIC):
                            ci = c * CIC + ch
                            if ci >= Ci or lo >= hi:
                                continue
                            row, off = _copy_row(xpad, base_off, (b * Ci + ci) * L + lo,
                                                 (b * Ci + ci) * L + hi)
                            assert len(row) <= rows + 16  # the staging row's room
                            r = np.arange(r_lo, rows)
                            pos = lbase + r
                            ok = (pos >= lo) & (pos < hi)
                            raw = row[pos[ok] - lo + off]
                            assert not np.isnan(raw).any()
                            win[r[ok], ch] = _snake(raw, alpha[ci], binv[ci])
                        # padding rows are exactly 0
                        pos = lbase + np.arange(rows)
                        assert not win[(pos < 0) | (pos >= L)].any()
                        if carry and tile + 1 < t1:
                            kept[c] = win[BM:BM + span].copy()
                        # two consumer warpgroups: 128-row halves of 256
                        # rows, or 128-channel halves of 256 channels
                        for wg in range(2):
                            r0, c0 = (0, nt * wg) if split else (128 * wg, 0)
                            for j in range(k):
                                a_j = win[r0 + j * d:r0 + j * d + 128]
                                b_j = wslab[j, c0:c0 + nt, c * CIC:(c + 1) * CIC]
                                acc[r0:r0 + 128, c0:c0 + nt] += a_j @ b_j.T
                    # epilogue: bias, residual, only rows < Lout and channels < Co
                    l0 = tile * BM
                    nl, nc = min(BM, Lout - l0), min(NB, Co - n0)
                    out = acc[:nl, :nc].T
                    if bias is not None:
                        out = out + bias[n0:n0 + nc, None]
                    if res is not None:
                        out = out + res[b, n0:n0 + nc, l0:l0 + nl]
                    y[b, n0:n0 + nc, l0:l0 + nl] = out
    assert not np.isnan(y).any()
    return y


def _inputs(seed, B, Ci, Co, L, k, d, bias=True, res=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, Ci, L)) * 2).astype(np.float32)
    w = (rng.standard_normal((Co, Ci, k)) * (Ci * k) ** -0.5).astype(np.float32)
    b_ = (rng.standard_normal(Co) * 0.1).astype(np.float32) if bias else None
    alpha = np.exp(rng.standard_normal(Ci) * 0.5).astype(np.float32)
    beta = np.exp(rng.standard_normal(Ci) * 0.5).astype(np.float32)
    Lout = L - (k - 1) * d + 2 * (d * (k - 1) // 2)
    r = rng.standard_normal((B, Co, Lout)).astype(np.float32) if res else None
    return x, w, b_, alpha, beta, r


def _jax(x, w, bias, alpha, beta, pad_lo, pad_hi, d, res=None):
    nlc = lambda t: jnp.asarray(t.transpose(0, 2, 1))
    jb = jnp.asarray(bias if bias is not None else np.zeros(w.shape[0], np.float32))
    args = (nlc(x), jnp.asarray(w.transpose(2, 1, 0)), jb, jnp.asarray(alpha),
            jnp.asarray(beta))
    if res is None:
        out = jcs.snake_conv1d(*args, pad_lo, pad_hi, d)
    else:
        out = jcs.snake_conv1d_res(*args, nlc(res), pad_lo, pad_hi, d)
    return np.asarray(out).transpose(0, 2, 1)


def _plain(x, w, bias, alpha, beta, pad_lo, pad_hi, d, res=None):
    t = lambda a: None if a is None else torch.from_numpy(a)
    return tcs.snake_conv1d_plain(t(x), t(w), t(bias), t(alpha), t(beta), pad_lo, pad_hi, d,
                                  t(res)).numpy()


def _close(name, got, want):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, (name, err)


# (B, Ci, Co, L, k, d, strip, bias, residual): k 1 / 3 / 7 at d 1 / 3 / 9;
# strips of one tile and of many; Ci = 33 (a partial chunk); Co = 2 (n8),
# 8, 200 (two 128-channel halves, the second ragged); L on either side of a
# 256-row (or, for Co > 128, 128-row) tile edge; the encoder's k = 3
# conv_out at L = 32 at a narrow width; row 3's k = 1 with the residual
CASES = [
    (1, 16, 16, 255, 7, 1, 1, True, False),
    (1, 16, 16, 257, 7, 3, 2, True, False),
    (2, 16, 16, 700, 7, 9, 3, True, False),
    (1, 33, 8, 513, 3, 9, 2, True, False),
    (1, 16, 2, 300, 7, 1, 2, False, False),
    (1, 24, 200, 129, 7, 3, 2, True, False),
    (1, 24, 200, 127, 3, 1, 1, True, False),
    (1, 96, 16, 32, 3, 1, 1, True, False),
    (2, 16, 16, 511, 1, 1, 2, True, True),
    (1, 33, 200, 257, 1, 1, 3, True, True),
]


@pytest.mark.parametrize("B,Ci,Co,L,k,d,strip,bias,res", CASES)
def test_emulated_tiles_match_jax_and_the_plain_version(B, Ci, Co, L, k, d, strip, bias, res):
    x, w, b_, a, bt, r = _inputs(B * L + Ci + Co + k * d, B, Ci, Co, L, k, d, bias, res)
    pad = d * (k - 1) // 2
    got = emulate(x, w, b_, a, bt, pad, pad, d, r, strip=strip, carry=not res)
    _close("plain", got, _plain(x, w, b_, a, bt, pad, pad, d, r))
    _close("jax", got, _jax(x, w, b_, a, bt, pad, pad, d, r))


@pytest.mark.parametrize("base_off,pads", [(0, (9, 9)), (2, (18, 0)), (6, (0, 18)),
                                           (14, (4, 14))])
def test_carry_is_a_schedule_not_arithmetic(base_off, pads):
    # row 12's strips with the carry against row 3's schedule (every tile
    # loads its halo again): the same bits, for copies that start off a
    # 16-byte boundary, an odd L and one-sided padding
    x, w, b_, a, bt, _ = _inputs(5, 2, 20, 8, 1001, 7, 3)
    pad_lo, pad_hi = pads
    carried = emulate(x, w, b_, a, bt, pad_lo, pad_hi, 3, strip=4, carry=True,
                      base_off=base_off)
    reloaded = emulate(x, w, b_, a, bt, pad_lo, pad_hi, 3, strip=1, base_off=base_off)
    assert np.array_equal(carried, reloaded)
    _close("plain", carried, _plain(x, w, b_, a, bt, pad_lo, pad_hi, 3))


def test_tile_plan_constants():
    # the Co tile is the least of n8 / n64 / n128 that covers Co, then two
    # 128-channel halves; a block is 256 rows x N or 128 rows x 256 channels
    assert [tcs.tile_n(c) for c in (2, 8, 9, 64, 65, 128, 129, 1024)] == [
        (8, False), (8, False), (64, False), (64, False), (128, False), (128, False),
        (128, True), (128, True)]
    assert tcs.block_tile(2) == (256, 8) and tcs.block_tile(1024) == (128, 256)
    assert tcs.CI_CHUNK == 64 and tcs.MAX_SPAN == 192

"""The snake-conv backward's index plans on Hopper, rehearsed in numpy on the
CPU and held against the JAX package: row 11 (`csrc/conv1d_wgrad.cu`, the
weight gradient) and row 10 (`csrc/snake_conv1d_dx.cu`, dx on the forward's
body in `csrc/snake_conv.cuh`).

`emulate_wgrad` walks the weight-gradient kernel's schedule from the
wrapper's own plan (`conv1d_snake.CI_CHUNK`, `wgrad_tile`, `wgrad_co_block`,
`wgrad_splits`): S splits of the (batch row, T-sample chunk) sequence, each
a run that may cross a batch row; per block one chunk of 64 input channels,
one co tile and a group of up to 8 taps; the window of T + (k-1)*d rows
(input times chunk * T - pad_lo + row, exact 0 outside
[0, L) and past Ci) carried from chunk to chunk of one batch row; the dy
stage zero past Co and Lout; the two warpgroups' taps (split, or all taps
over co halves) with tap j's operand j*d rows down the window, read in
16-row k-steps; the partials into a workspace [S, k, Co, Ci] that every
element of is written exactly once, summed over S in order; db from the
warpgroups of input chunk 0 whose taps start at 0.

`emulate_dx` walks the dx kernel's: the forward's body over the tile
`dx_tile(Ci)` with dy as the window (Co channels, no snake,
left offset (k-1)*d - pad_lo), the weights [k, Ci, Co_pad] read with the
taps flipped, strips of tiles with the carry, and the epilogue: the snake's
derivative at each output position and the dalpha / dbeta partials of each
warpgroup's 128 rows into [B, nblk, Ci], each written exactly once.

Seeded f32 inputs go through the emulations, the port's plain versions and
the JAX package's kernels in interpret mode (`_run_bwd_dw` with and without
`pre_snake` where its `wgrad_kernel_supported` gate takes the shape, else the
plain version alone; `_run_bwd_dx`). Tolerances, of each output's peak:
1e-5 against the plain versions and the JAX weight gradient (f32 both sides,
other summation orders); 3e-4 against the JAX dx, whose snake derivative is
a polynomial (1.1e-4 off the exact sines measured at 128 channels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops.kernels import conv1d_snake as jcs
from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as tcs

TOL = 1e-5
JAX_DX_TOL = 3e-4
SMS = 132  # an H100's SMs: the splits the wrapper would plan on the card


def _cdiv(a, b):
    return -(-a // b)


def _snake(v, a, binv):
    s = np.sin(a * v)
    return v + s * s * binv


def _window(xb, ch0, lbase, rows, r_lo, kept, snake):
    """Window rows [0, rows) x 64 channels from ch0 of xb [C, L]: row r is
    input time lbase + r, exactly 0 outside [0, L) and past C; rows below
    r_lo are the carry `kept`; the snake (a, binv) applied where given."""
    C, L = xb.shape
    win = np.zeros((rows, tcs.CI_CHUNK), np.float32)
    if r_lo:
        win[:r_lo] = kept
    r = np.arange(r_lo, rows)
    pos = lbase + r
    ok = (pos >= 0) & (pos < L)
    live = min(tcs.CI_CHUNK, C - ch0)
    raw = xb[ch0:ch0 + live][:, pos[ok]].T
    if snake is not None:
        a, binv = snake
        raw = _snake(raw, a[ch0:ch0 + live], binv[ch0:ch0 + live])
    win[r[ok], :live] = raw
    return win


def emulate_wgrad(x, dy, k, pad_lo, d, pre_snake=None, S=None):
    """(dW [Co, Ci, k], db [Co]) by the weight-gradient kernel's schedule."""
    B, Ci, L = x.shape
    _, Co, Lout = dy.shape
    CIC = tcs.CI_CHUNK
    mt, split, T = tcs.wgrad_tile(Co, k)
    co_blk = tcs.wgrad_co_block(Co, k)
    assert T in (128, 256) and (mt == 1 if split else mt * min(k, 8) <= 4)
    span = (k - 1) * d
    rows = T + span
    tiles = _cdiv(Lout, T)
    total = B * tiles
    if S is None:
        S = tcs.wgrad_splits(B, Ci, Co, Lout, k, SMS)
    per = _cdiv(total, S)
    assert _cdiv(total, per) == S  # no empty split
    carry = per > 1 and 0 < span <= T
    snake = None if pre_snake is None else (pre_snake[0], 1.0 / (pre_snake[1] + 1e-9))
    ws = np.full((S, k, Co, Ci), np.nan, np.float32)
    dbws = np.full((S, Co), np.nan, np.float32)
    writes = np.zeros((S, k, Co, Ci), np.int32)
    db_writes = np.zeros((S, Co), np.int32)
    for s in range(S):
        s0, s1 = s * per, min(s * per + per, total)
        for co0 in range(0, Co, co_blk):
            for j0 in range(0, k, 8):
                kg = min(8, k - j0)
                if split:  # one 64-channel co tile, the taps halved
                    first = (kg + 1) // 2
                    wgs = [(j0, first, 0), (j0 + first, kg - first, 0)]
                else:  # every tap, the co tile halved
                    wgs = [(j0, kg, 0), (j0, kg, 64 * mt)]
                assert all(nt * mt <= 4 for _, nt, _ in wgs)
                for cc in range(_cdiv(Ci, CIC)):
                    acc = [np.zeros((mt, nt, 64, CIC), np.float32) for _, nt, _ in wgs]
                    dsum = np.zeros(co_blk, np.float32)
                    kept = None
                    for seq in range(s0, s1):
                        b, tile = divmod(seq, tiles)
                        carried = carry and seq > s0 and tile > 0
                        keep = carry and seq + 1 < s1 and tile + 1 < tiles
                        win = _window(x[b], cc * CIC, tile * T - pad_lo, rows,
                                      span if carried else 0, kept, snake)
                        if keep:
                            kept = win[T:T + span].copy()
                        # the dy stage: T / 64 boxes of 64 samples x co_blk
                        # rows, zero past Co and Lout
                        st = np.zeros((co_blk, T), np.float32)
                        blk = dy[b, co0:co0 + co_blk, tile * T:tile * T + T]
                        st[:blk.shape[0], :blk.shape[1]] = blk
                        for w, (jb, nt, mrow) in enumerate(wgs):
                            for m in range(mt):
                                a_m = st[mrow + 64 * m:mrow + 64 * m + 64]
                                for jj in range(nt):
                                    r0 = (jb + jj) * d  # the tap's descriptor start row
                                    for kk in range(T // 16):
                                        rr = r0 + 16 * kk
                                        assert rr + 16 <= rows
                                        acc[w][m, jj] += (a_m[:, 16 * kk:16 * kk + 16]
                                                          @ win[rr:rr + 16])
                            if cc == 0 and jb == 0:
                                dsum[mrow:mrow + 64 * mt] += st[mrow:mrow + 64 * mt].sum(1)
                    for w, (jb, nt, mrow) in enumerate(wgs):
                        for m in range(mt):
                            r0 = co0 + mrow + 64 * m
                            nco, nci = min(64, Co - r0), min(CIC, Ci - cc * CIC)
                            if nco <= 0:
                                continue
                            for jj in range(nt):
                                sl = (s, jb + jj, slice(r0, r0 + nco),
                                      slice(cc * CIC, cc * CIC + nci))
                                ws[sl] = acc[w][m, jj, :nco, :nci]
                                writes[sl] += 1
                        if cc == 0 and jb == 0:
                            n = max(0, min(64 * mt, Co - co0 - mrow))
                            dbws[s, co0 + mrow:co0 + mrow + n] = dsum[mrow:mrow + n]
                            db_writes[s, co0 + mrow:co0 + mrow + n] += 1
    assert (writes == 1).all() and (db_writes == 1).all()
    dW, db = ws[0].copy(), dbws[0].copy()
    for s in range(1, S):  # `conv1d_wgrad_reduce`: the partials in order
        dW += ws[s]
        db += dbws[s]
    return dW.transpose(1, 2, 0), db


def emulate_dx(dy, x, w, alpha, beta, pad_lo, pad_hi, d, strip=1, carry=False):
    """(dx, dalpha, dbeta) by the dx kernel's schedule."""
    B, Co, Lout = dy.shape
    _, Ci, L = x.shape
    k = w.shape[-1]
    CIC = tcs.CI_CHUNK
    nt, split = tcs.dx_tile(Ci)
    BM, NB = (128, 2 * nt) if split else (256, nt)
    span = (k - 1) * d
    off = span - pad_lo  # dy's left offset: window row 0 is dy time tile * BM - off
    rows = BM + span
    nch = _cdiv(Co, CIC)
    assert not carry or nch > 1  # the plan carries only with two chunks of dy or more
    # the wrapper's weights [k, Ci, Co_pad], read with the taps flipped
    wp = np.zeros((k, Ci, nch * CIC), np.float32)
    wp[:, :, :Co] = w.transpose(2, 1, 0)
    binv = 1.0 / (beta + 1e-9)
    nblk = tcs.dx_blocks(Ci, L)
    tiles = _cdiv(L, BM)
    assert nblk == tiles * BM // 128
    dx = np.full((B, Ci, L), np.nan, np.float32)
    pa = np.full((B, nblk, Ci), np.nan, np.float32)
    pb = np.full((B, nblk, Ci), np.nan, np.float32)
    p_writes = np.zeros((B, nblk, Ci), np.int32)
    for b in range(B):
        for n0 in range(0, Ci, NB):
            wslab = np.zeros((k, NB, nch * CIC), np.float32)  # rows past Ci arrive as 0
            wslab[:, :min(NB, Ci - n0)] = wp[:, n0:n0 + NB]
            for t0 in range(0, tiles, strip):
                t1 = min(t0 + strip, tiles)
                kept = {}
                for tile in range(t0, t1):
                    r_lo = span if carry and tile > t0 else 0
                    acc = np.zeros((BM, NB), np.float32)
                    for c in range(nch):
                        win = _window(dy[b], c * CIC, tile * BM - off, rows, r_lo,
                                      kept.get(c), None)
                        if carry and tile + 1 < t1:
                            kept[c] = win[BM:BM + span].copy()
                        for wg in range(2):
                            r0, c0 = (0, nt * wg) if split else (128 * wg, 0)
                            for j in range(k):
                                a_j = win[r0 + j * d:r0 + j * d + 128]
                                b_j = wslab[k - 1 - j, c0:c0 + nt, c * CIC:(c + 1) * CIC]
                                acc[r0:r0 + 128, c0:c0 + nt] += a_j @ b_j.T
                    # the epilogue: each warpgroup's 128 rows x its channels
                    for wg in range(2):
                        r0, c0 = (0, nt * wg) if split else (128 * wg, 0)
                        l0 = tile * BM + r0
                        ch = np.arange(n0 + c0, min(n0 + c0 + nt, Ci))
                        if ch.size == 0:
                            continue
                        nl = max(0, min(128, L - l0))
                        g = acc[r0:r0 + nl, c0:c0 + ch.size].T  # [channels, rows]
                        xv = x[b, ch, l0:l0 + nl]
                        a, bi = alpha[ch, None], binv[ch, None]
                        sn, cs = np.sin(a * xv), np.cos(a * xv)
                        ds2 = 2.0 * sn * cs
                        dx[b, ch, l0:l0 + nl] = g * (1.0 + a * bi * ds2)
                        pa[b, l0 // 128, ch] = (g * xv * bi * ds2).sum(1)
                        pb[b, l0 // 128, ch] = (-g * sn * sn * bi * bi).sum(1)
                        p_writes[b, l0 // 128, ch] += 1
    assert not np.isnan(dx).any() and (p_writes == 1).all()
    return dx, pa.sum(axis=(0, 1)), pb.sum(axis=(0, 1))


def _inputs(seed, B, Ci, Co, L, k, d, pad_lo, pad_hi):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, Ci, L)) * 2).astype(np.float32)
    w = (rng.standard_normal((Co, Ci, k)) * (Ci * k) ** -0.5).astype(np.float32)
    alpha = np.exp(rng.standard_normal(Ci) * 0.5).astype(np.float32)
    beta = np.exp(rng.standard_normal(Ci) * 0.5).astype(np.float32)
    Lout = L + pad_lo + pad_hi - (k - 1) * d
    dy = rng.standard_normal((B, Co, Lout)).astype(np.float32)
    return x, w, alpha, beta, dy


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nlc(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1)))


def _close(name, got, want, tol=TOL):
    err = np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()
    assert err <= tol, (name, err)


def _check_wgrad(x, dy, k, pad_lo, pad_hi, d, alpha, beta, S=None):
    Ci, Co, Lout = x.shape[1], dy.shape[1], dy.shape[2]
    for snake in (None, (alpha, beta)):
        got = emulate_wgrad(x, dy, k, pad_lo, d, snake, S)
        want = tcs.conv1d_wgrad_plain(_t(dy), _t(x), k, pad_lo, pad_hi, d,
                                      None if snake is None else (_t(alpha), _t(beta)))
        _close("dW plain", got[0], want[0].numpy())
        _close("db plain", got[1], want[1].numpy())
        if jcs.wgrad_kernel_supported(k, Ci, Co, d, Lout):
            jw, jb = jcs._run_bwd_dw(_nlc(dy), _nlc(x), (k, Ci, Co),
                                     None if snake is None else tuple(map(jnp.asarray, snake)),
                                     pad_lo, pad_hi, d, True)
            _close("dW jax", got[0], np.asarray(jw).transpose(2, 1, 0))
            _close("db jax", got[1], np.asarray(jb).reshape(-1))


def _check_dx(x, w, alpha, beta, dy, pad_lo, pad_hi, d, strip, carry):
    got = emulate_dx(dy, x, w, alpha, beta, pad_lo, pad_hi, d, strip, carry)
    want = tcs.snake_conv1d_dx_plain(_t(dy), _t(x), _t(w), _t(alpha), _t(beta), pad_lo, pad_hi,
                                     d)
    for name, p, q in zip(("dx", "dalpha", "dbeta"), got, want):
        _close(name + " plain", p, q.numpy())
    jx = jcs._run_bwd_dx(_nlc(dy), _nlc(x), jnp.asarray(w.transpose(2, 1, 0)),
                         jnp.asarray(alpha), jnp.asarray(beta), pad_lo, pad_hi, d, True)
    _close("dx jax", got[0], np.asarray(jx[0]).transpose(0, 2, 1), JAX_DX_TOL)
    _close("dalpha jax", got[1], np.asarray(jx[1]), JAX_DX_TOL)
    _close("dbeta jax", got[2], np.asarray(jx[2]), JAX_DX_TOL)


# (B, Ci, Co, L, k, d, pad_lo, pad_hi): every VAE level's width with L cut to
# a few tiles, k 1 / 3 / 7 at d 1 / 3 / 9; Ci = 2 (the encoder's conv_in),
# Co = 2 (the decoder's conv_out); the encoder's 2048 -> 128 k = 3 at L 32;
# k = 9 (two tap groups); an asymmetric pad; the DAC decoders' last level (96
# channels: a 128-wide tile a third dead, half of the second input chunk
# zeros) at k = 7, d = 1 / 3 / 9, the mono DAC decoder's conv_out 96 -> 1 and
# its encoder's conv_in 1 -> 128 (one live channel of a 64-channel chunk)
CASES = [
    (2, 128, 128, 300, 7, 1, 3, 3), (1, 128, 128, 300, 7, 3, 9, 9),
    (1, 128, 128, 420, 7, 9, 27, 27), (2, 128, 128, 300, 1, 1, 0, 0),
    (1, 256, 256, 260, 7, 3, 9, 9), (1, 256, 256, 200, 1, 1, 0, 0),
    (1, 512, 512, 140, 7, 9, 27, 27), (1, 1024, 1024, 100, 7, 1, 3, 3),
    (1, 1024, 1024, 64, 1, 1, 0, 0), (2, 2, 128, 500, 7, 1, 3, 3),
    (2, 128, 2, 500, 7, 1, 3, 3), (2, 2048, 128, 32, 3, 1, 1, 1),
    (1, 64, 2048, 32, 7, 1, 3, 3), (1, 72, 40, 333, 3, 9, 18, 0),
    (1, 40, 96, 290, 9, 2, 8, 8),
    (1, 96, 96, 300, 7, 1, 3, 3), (1, 96, 96, 300, 7, 3, 9, 9), (1, 96, 96, 420, 7, 9, 27, 27),
    (2, 96, 1, 500, 7, 1, 3, 3), (2, 1, 128, 500, 7, 1, 3, 3),
]


@pytest.mark.parametrize("B,Ci,Co,L,k,d,pad_lo,pad_hi", CASES)
def test_emulated_wgrad_matches_jax_and_the_plain_version(B, Ci, Co, L, k, d, pad_lo, pad_hi):
    x, _, alpha, beta, dy = _inputs(B * L + Ci + Co + k * d, B, Ci, Co, L, k, d, pad_lo, pad_hi)
    _check_wgrad(x, dy, k, pad_lo, pad_hi, d, alpha, beta)


@pytest.mark.parametrize("B,L,S", [(1, 1100, 2), (2, 700, 3), (2, 1100, 4), (2, 500, 1)])
def test_wgrad_splits_cross_rows_and_break_the_carry(B, L, S):
    # split boundaries inside a batch row (the carry restarts) and across
    # rows (a split runs from one row's last chunk into the next's first),
    # and one split over everything
    x, _, alpha, beta, dy = _inputs(L + S, B, 16, 24, L, 7, 3, 9, 9)
    _check_wgrad(x, dy, 7, 9, 9, 3, alpha, beta, S)


@pytest.mark.parametrize("B,Ci,Co,L,k,d,pad_lo,pad_hi", CASES)
def test_emulated_dx_matches_jax_and_the_plain_version(B, Ci, Co, L, k, d, pad_lo, pad_hi):
    x, w, alpha, beta, dy = _inputs(B * L + Ci + Co + k * d + 1, B, Ci, Co, L, k, d, pad_lo,
                                    pad_hi)
    _check_dx(x, w, alpha, beta, dy, pad_lo, pad_hi, d, strip=2,
              carry=0 < (k - 1) * d <= 128 and Co > tcs.CI_CHUNK)


@pytest.mark.parametrize("pads", [(9, 9), (18, 0), (0, 18), (4, 14)])
def test_dx_carry_is_a_schedule_not_arithmetic(pads):
    # strips that carry dy's halo against tiles that load it again: the same
    # bits, for one-sided and asymmetric padding and an odd L; 72 channels of
    # dy, two chunks, as the plan asks of a carry
    x, w, alpha, beta, dy = _inputs(11, 2, 20, 72, 1001, 7, 3, *pads)
    carried = emulate_dx(dy, x, w, alpha, beta, *pads, 3, strip=4, carry=True)
    reloaded = emulate_dx(dy, x, w, alpha, beta, *pads, 3)
    for p, q in zip(carried, reloaded):
        assert np.array_equal(p, q)


def test_wgrad_plan_constants():
    # at most 4 (taps x 64-row tiles) of accumulators a warpgroup: split taps
    # past 4 of a group or at Co <= 64, else co halves of 64 (128 at k <= 2
    # and Co > 128); 256-sample chunks for 64-channel co tiles and k = 1 at
    # 128 channels; splits fill 132 SMs, none empty
    assert tcs.CI_CHUNK == 64
    assert [tcs.wgrad_tile(co, k) for co, k in ((128, 7), (2, 7), (2, 1), (128, 1), (256, 1),
                                                (1024, 2), (128, 3), (2048, 3), (64, 3),
                                                (128, 9))] == [
        (1, True, 256), (1, True, 256), (1, True, 256), (1, False, 256), (2, False, 128),
        (2, False, 128), (1, False, 128), (1, False, 128), (1, True, 256), (1, True, 256)]
    assert [tcs.wgrad_co_block(co, k) for co, k in ((128, 7), (128, 1), (512, 1))] == [64, 128,
                                                                                     256]
    # [4, 128, 65536] k 7: 2 co tiles x 2 input chunks, 32 splits of 1024 chunks
    assert tcs.wgrad_splits(4, 128, 128, 65536, 7, SMS) == 32
    assert tcs.wgrad_splits(4, 1024, 1024, 256, 7, SMS) == 1
    # dx: 64-channel warpgroups side by side past 64 channels, 128-row partials
    assert [tcs.dx_tile(c) for c in (2, 64, 65, 2048)] == [(8, False), (64, False), (64, True),
                                                          (64, True)]
    assert tcs.dx_blocks(128, 65536) == 512 and tcs.dx_blocks(64, 300) == 4

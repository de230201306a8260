"""The port's hand-written kernels against their plain PyTorch versions on a
CUDA card, at ragged shapes the main path does not reach (partial tiles,
channel counts off the 32/64 tiling, every prefix length).

Marked `cuda`: they skip where there is no card. On the card:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
Tolerance: bf16 outputs, 2 units in the last place at the reference's peak;
gradients, a relative bound stated at each test. Also: the autograd
wrappers' gradients against autograd through the plain versions.
"""

import pytest
import torch
import torch.nn.functional as F

from stable_audio_tools_tpu_torch.ops.kernels import conv1d_snake as cs
from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as fa
from stable_audio_tools_tpu_torch.ops.kernels import layer_norm as ln
from stable_audio_tools_tpu_torch.ops.kernels import snake as sn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, *shape, scale=1.0, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(got, want):
    tol = 2 * 2.0 ** -7 * max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got.float()).all() and err <= tol, (err, tol)


@pytest.mark.parametrize("B,H,N,P", [(1, 3, 131, 1), (2, 2, 69, 5), (1, 1, 128, 64),
                                     (1, 2, 100, 0)])
def test_flash_attention_prefix(dev, B, H, N, P):
    q, k, v = (_randn(dev, B, H, N, 64, seed=i) for i in range(3))
    out, lse = fa.flash_attention_prefix(q, k, v, P)
    want, want_lse = fa.flash_attention_prefix_plain(q, k, v, P)
    _close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


def test_flash_attention_prefix_reads_views(dev):
    # [B, H, N, 64] views of one fused [B, N, 3*H*64] projection output, as
    # the attention module hands them over: read through their strides
    fused = _randn(dev, 2, 131, 3 * 3 * 64, seed=3)
    q, k, v = (t.view(2, 131, 3, 64).transpose(1, 2) for t in fused.chunk(3, dim=-1))
    out, lse = fa.flash_attention_prefix(q, k, v, 1)
    want, want_lse = fa.flash_attention_prefix_plain(q, k, v, 1)
    _close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("C,beta", [(1536, False), (1000, True)])
def test_fused_layer_norm(dev, C, beta):
    x = _randn(dev, 3, 77, C, scale=3.0)
    g = _randn(dev, C, dtype=torch.float32, seed=1)
    b = _randn(dev, C, dtype=torch.float32, seed=2) if beta else None
    _close(ln.fused_layer_norm(x, g, b), ln.fused_layer_norm_plain(x, g, b))


# the edges of csrc/layer_norm.cu: rows of 16-byte vectors over 1 to 16
# vectors a lane (64 to 4096 bf16), lengths off the vector (100) and past
# the warp kernel's reach (16384) that take the block kernel, row counts
# that do not fill a 4-row block, gamma / beta in f32 and bf16
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 100, 768, 1000, 1024, 1536, 2048, 4096, 16384])
def test_fused_layer_norm_edges(dev, C, g_dtype, x_dtype):
    for rows, beta in ((1, False), (5, True), (2050, False)):
        x = _randn(dev, rows, C, scale=3.0, dtype=x_dtype)
        g = _randn(dev, C, dtype=g_dtype, seed=1)
        b = _randn(dev, C, dtype=g_dtype, seed=2) if beta else None
        _close(ln.fused_layer_norm(x, g, b), ln.fused_layer_norm_plain(x, g, b))


def test_fused_layer_norm_is_one_launch(dev):
    # one kernel a call, with gamma in f32 or bf16 (no cast launch), and under
    # no_grad the same bits as the autograd route
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = _randn(dev, 2, 1025, 1536, scale=3.0)
    for g in (_randn(dev, 1536, dtype=torch.float32, seed=1),
              _randn(dev, 1536, dtype=torch.bfloat16, seed=1)):
        ln.fused_layer_norm(x, g)
        torch.cuda.synchronize()
        before = ln.fused_layer_norm.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                ln.fused_layer_norm(x, g)
            torch.cuda.synchronize()
        # every kernel in the window is the LayerNorm's own (a cast of gamma
        # would add as many again under another name); the profiler may miss
        # the first launch of its window
        kernels = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        assert all("ln_warp_kernel" in k for k in kernels), kernels
        assert 19 <= sum(kernels.values()) <= 20, kernels
        assert ln.fused_layer_norm.launches - before == 20
    xg = x.detach().clone().requires_grad_()
    y = ln.fused_layer_norm(xg, g)
    assert y.grad_fn is not None
    with torch.no_grad():
        y0 = ln.fused_layer_norm(x, g)
    assert y0.grad_fn is None and torch.equal(y0, y.detach())


# the snake's shapes on the card (csrc/snake.cu): the SA-2.0 VAE's six
# snake_fused sites at batch 1 (rows of 32 to 65,536: many rows a block, one
# row over several vectors a thread), and ragged ones (L off the 16-byte
# vector, one element, rows over several column blocks)
SNAKE_SHAPES = [(1, 128, 65536), (1, 128, 32768), (1, 256, 8192), (1, 512, 2048),
                (1, 1024, 256), (1, 2048, 32), (2, 33, 5000), (3, 7, 100), (1, 1, 1),
                (2, 48, 700)]


def _snake_inputs(dev, B, C, L, dtype=torch.bfloat16):
    x, g = _randn(dev, B, C, L, scale=2.0, dtype=dtype), _randn(dev, B, C, L, seed=1, dtype=dtype)
    a = _randn(dev, C, dtype=torch.float32, seed=2).exp()
    b = _randn(dev, C, dtype=torch.float32, seed=3).exp()
    return x, g, a, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,C,L", SNAKE_SHAPES)
def test_snake_fused(dev, B, C, L, dtype):
    x, _, a, b = _snake_inputs(dev, B, C, L, dtype)
    _close(sn.snake_fused(x, a, b), sn.snake_fused_plain(x, a, b))


def test_snake_fused_reads_offset_views(dev):
    # a view off the 16-byte grid takes the one-element path
    buf = _randn(dev, 2 * 33 * 4096 + 1, scale=2.0)
    x = buf[1:].view(2, 33, 4096)
    a = _randn(dev, 33, dtype=torch.float32, seed=2).exp()
    b = _randn(dev, 33, dtype=torch.float32, seed=3).exp()
    _close(sn.snake_fused(x, a, b), sn.snake_fused_plain(x, a, b))
    g = _randn(dev, 2, 33, 4096, seed=1)
    got, want = sn.snake_fused_bwd(x, a, b, g), sn.snake_fused_bwd_plain(x, a, b, g)
    _close(got[0], want[0])
    for p, q in zip(got[1:], want[1:]):
        assert _rel_err(p, q) < 1e-2


def _kernels_of(fn, calls=10):
    """Kernel name -> launches of `calls` calls of fn, by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_snake_launches_csrc_snake_or_raises(dev, monkeypatch, direction):
    # the forward is one launch of snake_fwd_kernel, the backward one of
    # snake_bwd_kernel and one of its per-channel sums, nothing else (no
    # torch.sum, no Triton); each counts one host call; a library that does
    # not load raises, and nothing falls back to the plain version
    from stable_audio_tools_tpu_torch.ops.kernels import _build

    x, g, a, b = _snake_inputs(dev, 2, 64, 4096)
    fn, counter, names = ((lambda: sn.snake_fused(x, a, b), sn.snake_fused, ("snake_fwd_kernel",))
                          if direction == "forward" else
                          (lambda: sn.snake_fused_bwd(x, a, b, g), sn.snake_fused_bwd,
                           ("snake_bwd_kernel", "snake_bwd_reduce_kernel")))
    before = counter.launches
    kernels = _kernels_of(fn)
    assert counter.launches - before == 11
    assert all(any(n in k for n in names) for k in kernels), kernels
    for n in names:  # the profiler may miss the first launch of its window
        assert 9 <= sum(c for k, c in kernels.items() if n in k) <= 10, kernels

    def refuse(*args, **kwargs):
        raise RuntimeError("no library")

    monkeypatch.setattr(_build, "bind", refuse)
    before = counter.launches
    with pytest.raises(RuntimeError, match="no library"):
        fn()
    assert counter.launches == before


@pytest.mark.parametrize("Ci,Co,L,k,d,res,bias", [
    (40, 70, 129, 7, 5, False, True),
    (64, 2, 300, 7, 1, False, False),
    (96, 96, 65, 1, 1, True, True),
    (128, 128, 1000, 7, 9, True, True),
    # k = 3: the SA-2.0 VAE encoder's conv_out (2048 -> 128 at L = 32, one
    # ragged tile) and widths off the tiling
    (2048, 128, 32, 3, 1, False, True),
    (200, 64, 77, 3, 1, False, True),
])
def test_snake_conv1d(dev, Ci, Co, L, k, d, res, bias):
    x = _randn(dev, 2, Ci, L)
    w = _randn(dev, Co, Ci, k, scale=(Ci * k) ** -0.5, seed=1)
    bias_t = _randn(dev, Co, dtype=torch.float32, seed=2) if bias else None
    a = _randn(dev, Ci, dtype=torch.float32, seed=3).exp()
    b = _randn(dev, Ci, dtype=torch.float32, seed=4).exp()
    r = _randn(dev, 2, Co, L, seed=5) if res else None
    pad = d * (k - 1) // 2
    if res:
        got = cs.snake_conv1d_res(x, w, bias_t, a, b, r, pad, pad, d)
    else:
        got = cs.snake_conv1d(x, w, bias_t, a, b, pad, pad, d)
    _close(got, cs.snake_conv1d_plain(x, w, bias_t, a, b, pad, pad, d, r))


# SA-1.0's DAC widths: 96 and 192 channels (96 is off the 64-channel input
# chunks and leaves 32 dead columns of a 128-wide output tile), the residual
# units' k = 7 convs at d = 1, 3, 9 and k = 1 convs with the skip, and the
# decoder's conv_out 96 -> 2; DAC's snake is snake-beta with beta = alpha
@pytest.mark.parametrize("Ci,Co,L,k,d,res", [
    (96, 96, 4099, 7, 1, False), (96, 96, 3000, 7, 9, False), (96, 96, 4099, 1, 1, True),
    (192, 192, 2050, 7, 3, False), (192, 192, 2050, 1, 1, True), (96, 2, 4099, 7, 1, False),
    (192, 96, 1000, 7, 1, False)])
def test_snake_conv1d_dac_widths(dev, Ci, Co, L, k, d, res):
    x = _randn(dev, 1, Ci, L)
    w = _randn(dev, Co, Ci, k, scale=(Ci * k) ** -0.5, seed=1)
    bias_t = _randn(dev, Co, dtype=torch.float32, seed=2)
    a = _randn(dev, Ci, dtype=torch.float32, seed=3).exp()
    r = _randn(dev, 1, Co, L, seed=5) if res else None
    pad = d * (k - 1) // 2
    if res:
        got = cs.snake_conv1d_res(x, w, bias_t, a, a, r, pad, pad, d)
    else:
        got = cs.snake_conv1d(x, w, bias_t, a, a, pad, pad, d)
        # row 12 against row 3 on the same inputs: equal bit for bit
        zero = torch.zeros_like(got)
        assert torch.equal(got, cs.snake_conv1d_res(x, w, bias_t, a, a, zero, pad, pad, d))
    _close(got, cs.snake_conv1d_plain(x, w, bias_t, a, a, pad, pad, d, r))


@pytest.mark.parametrize("C", [96, 192, 768, 1536])
def test_snake_fused_dac_widths(dev, C):
    # the DAC decoder's snake sites (row 4) with beta = alpha
    x = _randn(dev, 1, C, 4100, scale=2.0)
    a = _randn(dev, C, dtype=torch.float32, seed=2).exp()
    _close(sn.snake_fused(x, a, a), sn.snake_fused_plain(x, a, a))


@pytest.mark.parametrize("rows,C", [(2 * 4096, 1024), (2 * 1024, 1280), (2 * 79, 768),
                                    (2 * 256, 1280)])
def test_fused_layer_norm_f32_sa1_widths(dev, rows, C):
    # row 2 in f32 at the SA-1.0 UNet's widths (its attention norms and the
    # 768-wide context), f32 gamma and beta, epsilon 1e-6: within 1e-5 of the
    # peak of the plain version (f32 both, other summation orders)
    x = _randn(dev, rows, C, scale=3.0, dtype=torch.float32) + 0.5
    g = _randn(dev, C, dtype=torch.float32, seed=1)
    b = _randn(dev, C, dtype=torch.float32, seed=2)
    got, want = ln.fused_layer_norm(x, g, b, 1e-6), ln.fused_layer_norm_plain(x, g, b, 1e-6)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("groups,C,L,dtype", [(1, 1024, 4096, torch.float32),
                                              (16, 1280, 1024, torch.float32),
                                              (32, 1024, 2048, torch.float32),
                                              (1, 128, 65536, torch.bfloat16)])
def test_group_norm_matches_f_group_norm_on_card(dev, groups, C, L, dtype):
    # ops/norms.py's GroupNorm (var_mean + addcmul; the ADP and Dance UNets')
    # against F.group_norm on f32 input: 1e-5 of the peak in f32, 2 bf16
    # ulps in bf16
    from stable_audio_tools_tpu_torch.ops.norms import GroupNorm

    norm = GroupNorm(groups, C).to(dev)
    with torch.no_grad():
        norm.weight.copy_(_randn(dev, C, dtype=torch.float32, seed=1))
        norm.bias.copy_(_randn(dev, C, dtype=torch.float32, seed=2))
        x = _randn(dev, 2, C, L, scale=2.0, dtype=dtype) + 0.25
        got = norm(x)
        want = F.group_norm(x.float(), groups, norm.weight, norm.bias, 1e-6)
    assert got.dtype == dtype
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    else:
        _close(got, want)


# [B, Ci, Co, L, k, d, pad_lo, pad_hi, bias]: widths off the tiling at a
# ragged L; the decoder's conv_out (Co = 2, no bias); many tiles per strip
# at a ragged L; the encoder's conv_out (2048 -> 128, k = 3, one ragged
# tile: a strip of one tile); Ci = 1024 at d = 9 (the widest carry); padding
# rows on one side only
CARRY_CASES = [(2, 40, 70, 129, 7, 5, 15, 15, True), (2, 64, 2, 300, 7, 1, 3, 3, False),
               (1, 128, 128, 128 * 300 + 17, 7, 3, 9, 9, True),
               (2, 2048, 128, 32, 3, 1, 1, 1, True), (1, 1024, 1024, 300, 7, 9, 27, 27, True),
               (2, 96, 64, 500, 7, 2, 12, 0, True), (2, 96, 64, 500, 7, 2, 0, 12, True)]


@pytest.mark.parametrize("B,Ci,Co,L,k,d,pad_lo,pad_hi,bias", CARRY_CASES)
def test_snake_conv1d_carry(dev, B, Ci, Co, L, k, d, pad_lo, pad_hi, bias):
    # row 12 (snake_conv1d) against the plain version (2 bf16 ulps) and
    # against row 3 (snake_conv1d_res with a zero residual: the same window
    # contents, tap loop and epilogue, + 0 in f32: equal bit for bit)
    x = _randn(dev, B, Ci, L, scale=2.0)
    w = _randn(dev, Co, Ci, k, scale=(Ci * k) ** -0.5, seed=1)
    bias_t = _randn(dev, Co, dtype=torch.float32, seed=2) if bias else None
    a = _randn(dev, Ci, dtype=torch.float32, seed=3).exp()
    b = _randn(dev, Ci, dtype=torch.float32, seed=4).exp()
    got = cs.snake_conv1d(x, w, bias_t, a, b, pad_lo, pad_hi, d)
    torch.cuda.synchronize()
    _close(got, cs.snake_conv1d_plain(x, w, bias_t, a, b, pad_lo, pad_hi, d))
    zero = torch.zeros_like(got)
    assert torch.equal(got, cs.snake_conv1d_res(x, w, bias_t, a, b, zero, pad_lo, pad_hi, d))


# [B, Ci, Co, L, k, d]: the edges of the forward kernels' tiles (256 output
# rows x N channels for Co <= 128, N = 8 / 64 / 128; 128 rows x 256
# channels above): Lout at a tile +-1, Co at the N tile +-1 (7 / 9, 63 / 65,
# 127 / 129, 255 / 257), Co = 2, Ci = 33 (a partial 64-channel chunk), strips
# of one tile (a short L) and of many (a long L at batch 1)
TILE_EDGE_CASES = [(2, 64, 128, 255, 7, 1), (2, 64, 128, 257, 7, 3), (1, 64, 128, 256, 1, 1),
                   (2, 64, 200, 127, 7, 1), (2, 64, 200, 129, 3, 9),
                   (1, 40, 7, 300, 7, 2), (1, 40, 9, 300, 7, 2), (1, 96, 63, 513, 3, 1),
                   (1, 96, 65, 511, 3, 1), (1, 64, 127, 600, 7, 9), (1, 64, 129, 600, 7, 9),
                   (1, 64, 255, 300, 7, 3), (1, 64, 257, 300, 7, 3), (2, 33, 2, 1000, 7, 1),
                   (2, 33, 64, 1000, 1, 1), (1, 128, 128, 256 * 400 + 3, 7, 9),
                   (1, 256, 256, 128 * 300 + 5, 7, 3)]


@pytest.mark.parametrize("B,Ci,Co,L,k,d", TILE_EDGE_CASES)
def test_snake_conv1d_tile_edges(dev, B, Ci, Co, L, k, d):
    # both rows against the plain version (2 bf16 ulps): row 12 without a
    # residual, row 3 with one; and row 12 against row 3 with a zero
    # residual, equal bit for bit
    x = _randn(dev, B, Ci, L, scale=2.0)
    w = _randn(dev, Co, Ci, k, scale=(Ci * k) ** -0.5, seed=1)
    bias_t = _randn(dev, Co, dtype=torch.float32, seed=2)
    a = _randn(dev, Ci, dtype=torch.float32, seed=3).exp()
    b = _randn(dev, Ci, dtype=torch.float32, seed=4).exp()
    pad = d * (k - 1) // 2
    got = cs.snake_conv1d(x, w, bias_t, a, b, pad, pad, d)
    torch.cuda.synchronize()
    _close(got, cs.snake_conv1d_plain(x, w, bias_t, a, b, pad, pad, d))
    r = _randn(dev, *got.shape, seed=5)
    _close(cs.snake_conv1d_res(x, w, bias_t, a, b, r, pad, pad, d),
           cs.snake_conv1d_plain(x, w, bias_t, a, b, pad, pad, d, r))
    assert torch.equal(got, cs.snake_conv1d_res(x, w, bias_t, a, b, torch.zeros_like(got),
                                                pad, pad, d))


def test_snake_conv1d_strips(dev):
    # strips of one tile where the grid alone fills the card, of many (with
    # the carry) at batch 1 over a long L
    assert cs.carry_strip_tiles(8, 128, 128, 512, 7, 1) == (1, False)
    strip, carried = cs.carry_strip_tiles(1, 128, 128, 256 * 400, 7, 9)
    assert strip > 1 and carried


def test_snake_conv1d_launches_row_12_or_raises(dev):
    # snake_conv1d launches row 12 and counts it, snake_conv1d_res row 3 with
    # its own counter; an f32 CUDA input raises rather than falling back to
    # row 3 or to the plain version
    x, r = _randn(dev, 1, 64, 700), _randn(dev, 1, 64, 700, seed=5)
    w, w1 = _randn(dev, 64, 64, 7, scale=0.05, seed=1), _randn(dev, 64, 64, 1, scale=0.1, seed=2)
    a = b = torch.ones(64, device=dev)
    before = {f: f.launches for f in (cs.snake_conv1d, cs.snake_conv1d_res)}
    cs.snake_conv1d(x, w, None, a, b, 9, 9, 3)
    cs.snake_conv1d_res(x, w1, None, a, b, r, 0, 0, 1)
    assert cs.snake_conv1d.launches - before[cs.snake_conv1d] == 1
    assert cs.snake_conv1d_res.launches - before[cs.snake_conv1d_res] == 1
    with pytest.raises(TypeError):
        cs.snake_conv1d(x.float(), w.float(), None, a, b, 9, 9, 3)
    assert cs.snake_conv1d.launches - before[cs.snake_conv1d] == 1


def test_snake_conv1d_carry_strips_and_refusals(dev):
    # a carry too large for shared memory beside the rings (1024 channels x
    # 186 rows) is not kept; a narrow one is, in long strips; span > MAX_SPAN
    # and f32 inputs are refused
    x = _randn(dev, 1, 1024, 500, scale=2.0)
    a = b = torch.ones(1024, device=dev)
    w = _randn(dev, 8, 1024, 7, scale=0.01, seed=1)
    assert not cs.carry_strip_tiles(1, 1024, 8, 500, 7, 31)[1]
    _close(cs.snake_conv1d(x, w, None, a, b, 93, 93, 31),
           cs.snake_conv1d_plain(x, w, None, a, b, 93, 93, 31))
    x2 = _randn(dev, 1, 128, 128 * 1200, scale=2.0)  # 600 tiles: more than one per SM
    strip, carried = cs.carry_strip_tiles(1, 128, 8, 128 * 1200, 7, 1)
    assert strip > 1 and carried
    _close(cs.snake_conv1d(x2, w[:, :128], None, a[:128], b[:128], 3, 3, 1),
           cs.snake_conv1d_plain(x2, w[:, :128], None, a[:128], b[:128], 3, 3, 1))
    with pytest.raises(ValueError, match="exceeds"):  # span 198 > MAX_SPAN
        cs.snake_conv1d(x[:, :64], _randn(dev, 64, 64, 7), None, a[:64], b[:64], 99, 99, 33)
    with pytest.raises(TypeError):
        cs.snake_conv1d(x.float(), w.float(), None, a, b, 3, 3, 1)


def test_wrappers_raise_on_unsupported_cuda_input(dev):
    q = torch.zeros(1, 1, 65, 64, device=dev)  # f32: the kernel takes bf16
    with pytest.raises(TypeError):
        fa.flash_attention_prefix(q, q, q, 1)
    x = torch.zeros(1, 8, 32, device=dev)
    w = torch.zeros(8, 8, 3, device=dev)
    with pytest.raises(TypeError):
        cs.snake_conv1d(x, w, None, torch.ones(8, device=dev), torch.ones(8, device=dev),
                        1, 1, 1)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("B,H,N,P", [(1, 3, 131, 1), (2, 2, 69, 5), (1, 1, 128, 0),
                                     (2, 4, 1025, 1)])
def test_flash_attention_prefix_bwd_routes(dev, route, B, H, N, P):
    # both backward routes against the plain f32 backward on the same bf16
    # inputs and saved output/lse; P and dS are rounded to bf16 before the
    # products, so the bound is relative: 2e-2 of each gradient's peak
    q, k, v, g = (_randn(dev, B, H, N, 64, seed=i) for i in range(4))
    out, lse = fa.flash_attention_prefix(q, k, v, P)
    got = fa.flash_attention_prefix_bwd(q, k, v, out, lse, g, route=route)
    want = fa.flash_attention_prefix_bwd_plain(q, k, v, out, lse, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all(), name
        assert _rel_err(a, b) < 2e-2, (name, _rel_err(a, b))


def test_wrapper_gradients_on_card(dev):
    # the kernels inside autograd: a CUDA input that requires grad gets an
    # output with a grad_fn, and the gradients match autograd through the
    # plain versions on the same card (flash: 2e-2 relative, as above;
    # LayerNorm: bf16 dx, f32 dgamma/dbeta, 1e-2 relative)
    q, k, v = (_randn(dev, 2, 3, 130, 64, seed=i).requires_grad_() for i in range(3))
    w = _randn(dev, 2, 3, 130, 64, seed=9)
    out, _ = fa.flash_attention_prefix(q, k, v, 1)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    ref_out, _ = fa.flash_attention_prefix_plain(q, k, v, 1)
    want = torch.autograd.grad((ref_out.float() * w.float()).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert _rel_err(a, b) < 2e-2
    x = _randn(dev, 3, 77, 1536, scale=3.0).requires_grad_()
    gamma = _randn(dev, 1536, dtype=torch.float32, seed=1).requires_grad_()
    beta = _randn(dev, 1536, dtype=torch.float32, seed=2).requires_grad_()
    dy = _randn(dev, 3, 77, 1536, seed=3)
    y = ln.fused_layer_norm(x, gamma, beta)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y.float() * dy.float()).sum(), (x, gamma, beta))
    want = torch.autograd.grad((ln.fused_layer_norm_plain(x, gamma, beta).float()
                                * dy.float()).sum(), (x, gamma, beta))
    for a, b in zip(got, want):
        assert _rel_err(a, b) < 1e-2


def test_snake_wrapper_gradients_on_card(dev):
    # the snake and snake-conv autograd Functions on the card (forward and
    # backward kernels) against autograd through the plain versions on the
    # same bf16 inputs: bf16 dx, f32 parameter gradients summed over the batch
    # and time in another order: 1e-2 of each gradient's peak
    a = _randn(dev, 48, dtype=torch.float32, seed=3).exp().requires_grad_()
    b = _randn(dev, 48, dtype=torch.float32, seed=4).exp().requires_grad_()
    x = _randn(dev, 2, 48, 700, scale=2.0).requires_grad_()
    w = _randn(dev, 40, 48, 7, scale=(48 * 7) ** -0.5, seed=1).requires_grad_()
    bias = _randn(dev, 40, dtype=torch.float32, seed=2).requires_grad_()
    r = _randn(dev, 2, 40, 700, seed=5).requires_grad_()
    g = _randn(dev, 2, 40, 700, seed=6)
    gs = _randn(dev, 2, 48, 700, seed=7)
    cases = (
        ("snake_fused", (x, a, b), lambda: sn.snake_fused(x, a, b),
         lambda: sn.snake_fused_plain(x, a, b), gs),
        ("snake_conv1d", (x, w, bias, a, b), lambda: cs.snake_conv1d(x, w, bias, a, b, 9, 9, 3),
         lambda: cs.snake_conv1d_plain(x, w, bias, a, b, 9, 9, 3), g),
        ("snake_conv1d_res", (x, w, bias, a, b, r),
         lambda: cs.snake_conv1d_res(x, w, bias, a, b, r, 9, 9, 3),
         lambda: cs.snake_conv1d_plain(x, w, bias, a, b, 9, 9, 3, r), g),
    )
    for name, inputs, kernel, plain, cot in cases:
        y = kernel()
        assert y.grad_fn is not None, name
        got = torch.autograd.grad((y.float() * cot.float()).sum(), inputs)
        want = torch.autograd.grad((plain().float() * cot.float()).sum(), inputs)
        for i, (p, q) in enumerate(zip(got, want)):
            assert p.dtype == inputs[i].dtype and _rel_err(p, q) < 1e-2, (name, i, _rel_err(p, q))
    with torch.no_grad():  # the frozen encoder's way: no autograd
        assert sn.snake_fused(x, a, b).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,C,L", SNAKE_SHAPES + [(1, 128, 4096)])
def test_snake_fused_bwd(dev, B, C, L, dtype):
    # row 9 (csrc/snake.cu): dx within 2 bf16 ulps; dalpha/dbeta f32 sums in
    # another order, 1e-2 of their peak
    x, g, a, b = _snake_inputs(dev, B, C, L, dtype)
    got = sn.snake_fused_bwd(x, a, b, g)
    want = sn.snake_fused_bwd_plain(x, a, b, g)
    assert got[0].dtype == x.dtype and got[1].dtype == got[2].dtype == torch.float32
    _close(got[0], want[0])
    for p, q in zip(got[1:], want[1:]):
        assert _rel_err(p, q) < 1e-2


@pytest.mark.parametrize("B,C,L", [(4, 128, 65536), (4, 2048, 32), (2, 48, 700)])
def test_snake_fused_bwd_is_deterministic(dev, B, C, L):
    # the per-channel sums go through a workspace in a fixed order (no float
    # atomics): two calls give the same bits
    x, g, a, b = _snake_inputs(dev, B, C, L)
    first, second = sn.snake_fused_bwd(x, a, b, g), sn.snake_fused_bwd(x, a, b, g)
    assert all(torch.equal(p, q) for p, q in zip(first, second))


# (Ci, Co, L, k, d, pad): widths off the 32/64 tiling, Co = 2 (the decoder's
# conv_out), a dilated k = 7 with a ragged tail, k = 1, k = 3 with Lout < L
# tiles (the encoder's conv_out), an asymmetric pad
DX_CASES = [(36, 70, 129, 7, 5, 15), (128, 2, 300, 7, 1, 3), (96, 96, 65, 1, 1, 0),
            (128, 128, 1000, 7, 9, 27), (200, 64, 32, 3, 1, 1), (64, 48, 77, 4, 2, 2)]
# the backward kernels' tile edges: Ci or Co 2, 8, 64, 128, 256, 2048 (dx's
# n8 and 64-channel tiles, row 11's co tiles of 64 / 128 / 256 and chunks of
# 64 input channels); taps split across the warpgroups (k 5, 7, 9: two tap
# groups) or all taps over co halves (k 1, 2, 3); one split (S = 1: 2048
# and 1024 channels at short L) and many (long L, the halo carried); L not
# a multiple of 8
BWD_EDGE_CASES = [(2, 64, 1001, 7, 1, 3), (8, 8, 517, 7, 3, 9), (64, 256, 300, 1, 1, 0),
                  (256, 128, 2051, 3, 3, 3), (2048, 64, 40, 3, 1, 1), (128, 2048, 32, 1, 1, 0),
                  (128, 128, 20003, 9, 2, 8), (1024, 1024, 64, 1, 1, 0), (8, 200, 999, 5, 3, 6),
                  (256, 512, 700, 2, 3, 3)]


@pytest.mark.parametrize("Ci,Co,L,k,d,pad", DX_CASES + BWD_EDGE_CASES)
def test_snake_conv1d_dx(dev, Ci, Co, L, k, d, pad):
    # kernel B: dx within 2 bf16 ulps of the plain version, dalpha/dbeta
    # within 1e-2 of their peak
    x = _randn(dev, 2, Ci, L, scale=2.0)
    w = _randn(dev, Co, Ci, k, scale=(Ci * k) ** -0.5, seed=1)
    a = _randn(dev, Ci, dtype=torch.float32, seed=3).exp()
    b = _randn(dev, Ci, dtype=torch.float32, seed=4).exp()
    Lout = L + 2 * pad - (k - 1) * d
    dy = _randn(dev, 2, Co, Lout, seed=5)
    got = cs.snake_conv1d_dx(dy, x, w, a, b, pad, pad, d)
    want = cs.snake_conv1d_dx_plain(dy, x, w, a, b, pad, pad, d)
    _close(got[0], want[0])
    for p, q in zip(got[1:], want[1:]):
        assert _rel_err(p, q) < 1e-2


@pytest.mark.parametrize("snake", [False, True])
@pytest.mark.parametrize("Ci,Co,L,k,d,pad", DX_CASES + [(2, 128, 3000, 7, 1, 3),
                                                        (64, 200, 32, 7, 1, 3)] + BWD_EDGE_CASES)
def test_conv1d_wgrad(dev, snake, Ci, Co, L, k, d, pad):
    # kernels C (snake) and D (plain), with Ci = 2 (the encoder's conv_in) and
    # Ci = 64 -> 200 at L = 32: dW and db are f32 sums over B*Lout in
    # another order, 1e-2 of each one's peak
    x = _randn(dev, 2, Ci, L, scale=2.0)
    a = _randn(dev, Ci, dtype=torch.float32, seed=3).exp()
    b = _randn(dev, Ci, dtype=torch.float32, seed=4).exp()
    Lout = L + 2 * pad - (k - 1) * d
    dy = _randn(dev, 2, Co, Lout, seed=5)
    if snake:
        got = cs.snake_conv1d_wgrad(dy, x, k, a, b, pad, pad, d)
    else:
        got = cs.conv1d_wgrad(dy, x, k, pad, pad, d)
    want = cs.conv1d_wgrad_plain(dy, x, k, pad, pad, d, (a, b) if snake else None)
    for p, q in zip(got, want):
        assert p.dtype == torch.float32 and p.shape == q.shape and _rel_err(p, q) < 1e-2


# the plain weight gradient at Dance Diffusion's shapes, batch 4: k = 5 from
# the input conv (18 -> 128) and the output conv (128 -> 2) at 65,536
# samples to the concatenated up convs (1024 -> 512) at the innermost 8
# samples, a ragged 9 and 4096; the k = 1 skip and attention projections
DANCE_WGRAD_CASES = [(18, 128, 65536, 5), (128, 2, 65536, 5), (1024, 512, 8, 5),
                     (1024, 512, 9, 5), (1024, 512, 4096, 5), (256, 128, 32768, 1),
                     (512, 1536, 256, 1), (512, 512, 8, 1)]


@pytest.mark.parametrize("Ci,Co,L,k", DANCE_WGRAD_CASES)
def test_conv1d_wgrad_dance_shapes(dev, Ci, Co, L, k):
    # kernel D: dW and db within 1e-2 of each one's peak (f32 sums over
    # 4 x L in another order)
    pad = k // 2
    x, dy = _randn(dev, 4, Ci, L), _randn(dev, 4, Co, L, seed=5)
    got = cs.conv1d_wgrad(dy, x, k, pad, pad, 1)
    want = cs.conv1d_wgrad_plain(dy, x, k, pad, pad, 1)
    for p, q in zip(got, want):
        assert p.dtype == torch.float32 and p.shape == q.shape and _rel_err(p, q) < 1e-2


# DAC VAE-GAN generator steps at batch 4 (L cut where a case alone would be
# long): the 96-channel decoder level at k = 7, d = 1 / 3 / 9 and k = 1, the
# conv_outs 96 -> 2 / 96 -> 1, the 768 level, the encoder's 2048 -> 2048
# k = 3 at 64 and 32 samples; DAC's snake, beta passed as alpha
DAC_BWD_CASES = [(96, 96, 65536, 7, 1, 3), (96, 96, 16384, 7, 3, 9), (96, 96, 16384, 7, 9, 27),
                 (96, 96, 65536, 1, 1, 0), (96, 2, 65536, 7, 1, 3), (96, 1, 65536, 7, 1, 3),
                 (768, 768, 512, 7, 9, 27), (2048, 2048, 64, 3, 1, 1), (2048, 2048, 32, 3, 1, 1)]


def _launched(fn, *args):
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before + 1, "no kernel launch: the shape fell back"
    return out


@pytest.mark.parametrize("Ci,Co,L,k,d,pad", DAC_BWD_CASES)
def test_snake_conv_bwd_dac_shapes(dev, Ci, Co, L, k, d, pad):
    # rows 10 and 11 with alpha tied to beta, each call launching its
    # kernel: dx within 2 bf16 ulps, dalpha + dbeta (the tied parameter's
    # gradient), dW and db within 1e-2 of their peaks
    x = _randn(dev, 4, Ci, L, scale=2.0)
    w = _randn(dev, Co, Ci, k, scale=(Ci * k) ** -0.5, seed=1)
    a = _randn(dev, Ci, dtype=torch.float32, seed=3).exp()
    dy = _randn(dev, 4, Co, L, seed=5)
    got = _launched(cs.snake_conv1d_dx, dy, x, w, a, a, pad, pad, d)
    want = cs.snake_conv1d_dx_plain(dy, x, w, a, a, pad, pad, d)
    _close(got[0], want[0])
    assert _rel_err(got[1] + got[2], want[1] + want[2]) < 1e-2
    got = _launched(cs.snake_conv1d_wgrad, dy, x, k, a, a, pad, pad, d)
    want = cs.conv1d_wgrad_plain(dy, x, k, pad, pad, d, (a, a))
    for p, q in zip(got, want):
        assert _rel_err(p, q) < 1e-2


@pytest.mark.parametrize("Ci,Co,L", [(1, 128, 65536), (2, 128, 65536), (64, 1536, 64),
                                     (32, 1536, 32)])
def test_conv1d_wgrad_dac_conv_ins(dev, Ci, Co, L):
    # row 11 plain at the DAC towers' conv_ins (k = 7), batch 4: one live
    # input channel of a 64-channel chunk, and 1536 outputs at 32 / 64
    # samples; dW and db within 1e-2 of their peaks
    x, dy = _randn(dev, 4, Ci, L), _randn(dev, 4, Co, L, seed=5)
    got = _launched(cs.conv1d_wgrad, dy, x, 7, 3, 3, 1)
    want = cs.conv1d_wgrad_plain(dy, x, 7, 3, 3, 1)
    for p, q in zip(got, want):
        assert p.shape == q.shape and _rel_err(p, q) < 1e-2


@pytest.mark.parametrize("C,L", [(128, 65536), (1536, 32), (192, 16384), (1024, 256)])
def test_snake_fused_bwd_tied_alpha_dac_sites(dev, C, L):
    # row 9 at DAC snake sites, batch 4, alpha passed as beta: dx within 2
    # bf16 ulps, dalpha + dbeta within 1e-2 of the peak
    x, g, a, _ = _snake_inputs(dev, 4, C, L)
    got = _launched(sn.snake_fused_bwd, x, a, a, g)
    want = sn.snake_fused_bwd_plain(x, a, a, g)
    _close(got[0], want[0])
    assert _rel_err(got[1] + got[2], want[1] + want[2]) < 1e-2


def test_dac_vae_generator_step_launches_the_kernels(dev):
    # a tiny DAC VAE's generator step on the card in bf16: every snake-conv,
    # snake and plain conv of the towers launches its kernel (the counts of
    # models/dac.py's layers), and every gradient is finite
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    enc = {"in_channels": 1, "latent_dim": 8, "d_model": 16, "strides": [2, 4]}
    dec = {"latent_dim": 4, "channels": 96, "rates": [4, 2]}
    scales = {"n_ffts": [64, 32], "hop_lengths": [16, 8], "win_lengths": [64, 32]}
    config = {"model_type": "autoencoder", "sample_size": 4096, "sample_rate": 44100,
              "audio_channels": 1,
              "model": {"encoder": {"type": "dac", "config": enc},
                        "decoder": {"type": "dac", "config": dec}, "bottleneck": {"type": "vae"},
                        "latent_dim": 4, "downsampling_ratio": 8, "io_channels": 1},
              "training": {"learning_rate": 1e-4, "compute_dtype": "bfloat16", "loss_configs": {
                  "discriminator": {"type": "encodec", "config": dict(scales, filters=4),
                                    "weights": {"adversarial": 0.1, "feature_matching": 5.0}},
                  "spectral": {"type": "mrstft", "config": {
                      "fft_sizes": [64, 32], "hop_sizes": [16, 8], "win_lengths": [64, 32],
                      "perceptual_weighting": True}, "weights": {"mrstft": 1.0}}}}}
    model = init_random_(create_model_from_config(config, dev), torch.Generator(dev).manual_seed(0))
    w = create_training_wrapper_from_config(config, model)
    fns = {"snake_conv1d": cs.snake_conv1d, "snake_conv1d_res": cs.snake_conv1d_res,
           "snake_conv1d_dx": cs.snake_conv1d_dx, "snake_conv1d_wgrad": cs.snake_conv1d_wgrad,
           "conv1d_wgrad": cs.conv1d_wgrad, "snake_fused": sn.snake_fused,
           "snake_fused_bwd": sn.snake_fused_bwd}
    before = {n: f.launches for n, f in fns.items()}
    w.train_step(_randn(dev, 2, 1, 4096, dtype=torch.float32, scale=0.3))
    got = {n: f.launches - before[n] for n, f in fns.items()}
    # 2 levels a tower, 3 residual units a level, a snake-conv conv_out each
    assert got == {"snake_conv1d": 14, "snake_conv1d_res": 12, "snake_conv1d_dx": 26,
                   "snake_conv1d_wgrad": 26, "conv1d_wgrad": 2, "snake_fused": 4,
                   "snake_fused_bwd": 4}, got
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in w.params.values())


# a codec generator step at batch 4 x 32,000 (encodec_musicgen_rvq.json's
# SEANet in bf16 up to its LSTMs): each stride-1 conv pads x itself
# (reflect), so row 11 plain takes pad 0 on the padded length; (Ci, Co, k,
# padded L): the conv_in 1 -> 64 at k = 7, the residual blocks' k = 3 and
# k = 1 convs and shortcuts of each level (Co 32 fills half a 64-row
# block), the decoder's conv_in 128 -> 1024 at 50 frames
CODEC_WGRAD_CASES = [(1, 64, 7, 32006), (64, 32, 3, 32002), (32, 64, 1, 32000),
                     (64, 64, 1, 32000), (128, 64, 3, 8002), (64, 128, 1, 8000),
                     (128, 128, 1, 8000), (256, 128, 3, 2002), (128, 256, 1, 2000),
                     (256, 256, 1, 2000), (512, 256, 3, 402), (256, 512, 1, 400),
                     (512, 512, 1, 400), (128, 1024, 7, 56)]


@pytest.mark.parametrize("Ci,Co,k,L", CODEC_WGRAD_CASES)
def test_conv1d_wgrad_codec_shapes(dev, Ci, Co, k, L):
    # each call launching the kernel; dW and db within 1e-2 of their peaks
    x, dy = _randn(dev, 4, Ci, L), _randn(dev, 4, Co, L - k + 1, seed=5)
    got = _launched(cs.conv1d_wgrad, dy, x, k, 0, 0, 1)
    want = cs.conv1d_wgrad_plain(dy, x, k, 0, 0, 1)
    for p, q in zip(got, want):
        assert p.shape == q.shape and _rel_err(p, q) < 1e-2


def test_codec_generator_step_launches_row11_plain(dev):
    # a tiny EnCodec-shaped codec's generator step on the card in bf16:
    # each stride-1 conv before an LSTM (the encoder's conv_in, a residual
    # block's two convs and shortcut a level; the decoder's conv_in)
    # launches `conv1d_wgrad`, no other hand-written kernel launches, and
    # every gradient is finite
    import json
    import os

    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "stable_audio_tools_tpu", "configs", "model_configs",
                           "autoencoders", "encodec_musicgen_rvq.json")) as f:
        config = json.load(f)
    config["sample_size"] = 4096
    m = config["model"]
    for side in ("encoder", "decoder"):
        m[side]["config"].update(n_filters=8, ratios=[2, 4], dimension=16)
    m["bottleneck"]["config"].update(num_quantizers=2, codebook_size=32, dim=16)
    m.update(latent_dim=16, downsampling_ratio=8)
    config["training"]["loss_configs"]["discriminator"]["config"] = dict(
        filters=4, n_ffts=[64, 32], hop_lengths=[16, 8], win_lengths=[64, 32])
    config["training"]["loss_configs"]["spectral"]["config"].update(
        fft_sizes=[64, 32], hop_sizes=[16, 8], win_lengths=[64, 32])
    model = init_random_(create_model_from_config(config, dev), torch.Generator(dev).manual_seed(0))
    w = create_training_wrapper_from_config(config, model)
    assert w.compute_dtype == torch.bfloat16
    fns = {"snake_conv1d": cs.snake_conv1d, "snake_conv1d_res": cs.snake_conv1d_res,
           "snake_conv1d_dx": cs.snake_conv1d_dx, "snake_conv1d_wgrad": cs.snake_conv1d_wgrad,
           "conv1d_wgrad": cs.conv1d_wgrad, "snake_fused": sn.snake_fused,
           "snake_fused_bwd": sn.snake_fused_bwd}
    before = {n: f.launches for n, f in fns.items()}
    w.train_step(_randn(dev, 2, 1, 4096, dtype=torch.float32, scale=0.3))
    got = {n: f.launches - before[n] for n, f in fns.items() if f.launches != before[n]}
    assert got == {"conv1d_wgrad": 2 + 3 * len(model.encoder.blocks)}, got
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in w.params.values())


def test_dance_trainer_refuses_f32_on_the_card(dev):
    # the DAU1d's convs reach conv1d_wgrad, which takes bf16 only: an f32
    # model is refused when its trainer is built, not in its first backward
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    config = {"model_type": "diffusion_uncond", "sample_size": 64, "sample_rate": 16000,
              "model": {"type": "DAU1d", "config": {"io_channels": 2, "depth": 3,
                                                     "n_attn_layers": 1, "channels": [8, 16, 32],
                                                     "strides": [2, 2]}},
              "training": {"learning_rate": 1e-4}}
    for dtype in (None, "float32"):
        config["model"]["config"]["compute_dtype"] = dtype
        with pytest.raises(TypeError, match="bfloat16"):
            create_training_wrapper_from_config(config, create_model_from_config(config, dev))
    config["model"]["config"]["compute_dtype"] = "bfloat16"
    w = create_training_wrapper_from_config(config, create_model_from_config(config, dev))
    launches = cs.conv1d_wgrad.launches
    aux = w.train_step(_randn(dev, 2, 2, 64, dtype=torch.float32), [{}, {}])
    assert torch.isfinite(aux["loss"])
    assert cs.conv1d_wgrad.launches - launches == w.model.model.conv_sites()


def test_a_weighting_fir_is_full_f32_on_card(dev):
    # the MRSTFT loss's FIR (cuDNN) in both directions against f64 on the
    # CPU: 1e-5 of the peak, which TF32's 10-bit mantissa would miss by ~100x
    from stable_audio_tools_tpu_torch.ops import stft

    taps = stft.a_weighting_fir(101, 44100)
    x = _randn(dev, 2, 2, 5000, dtype=torch.float32).requires_grad_()
    g = _randn(dev, 2, 2, 5000, dtype=torch.float32, seed=1)
    y = stft.apply_fir(x, taps)
    (dx,) = torch.autograd.grad((y * g).sum(), x)
    k = torch.from_numpy(taps).double()[None, None]
    x64 = x.detach().cpu().double().reshape(-1, 1, 5000).requires_grad_()
    y64 = torch.nn.functional.conv1d(x64, k, padding=50)
    (dx64,) = torch.autograd.grad((y64 * g.cpu().double().reshape(-1, 1, 5000)).sum(), x64)
    assert _rel_err(y.cpu().reshape(-1, 1, 5000), y64) < 1e-5
    assert _rel_err(dx.cpu().reshape(-1, 1, 5000), dx64) < 1e-5


def _nhd_inputs(dev, B, N, H, layout):
    """q, k, v [B, N, H, 64]: fresh contiguous tensors, strided views of one
    fused [B, N, 3*H*64] projection output, or a mix (q and k fresh as after
    the rotary, v still a view)."""
    if layout == "contiguous":
        return tuple(_randn(dev, B, N, H, 64, seed=i) for i in range(3))
    fused = _randn(dev, B, N, 3 * H * 64, seed=7)
    q, k, v = (t.view(B, N, H, 64) for t in fused.chunk(3, dim=-1))
    if layout == "mixed":
        q, k = q.clone(), k.clone()
    return q, k, v


@pytest.mark.parametrize("layout", ["contiguous", "fused_views", "mixed"])
@pytest.mark.parametrize("B,N,H,P,causal", [
    (1, 131, 3, 1, False), (2, 69, 2, 0, False), (1, 200, 1, 64, False),
    (1, 257, 5, 128, False), (2, 193, 3, 100, False), (1, 131, 3, 0, True),
    (2, 64, 2, 0, True), (1, 1025, 4, 1, False)])
def test_flash_attention_nhd(dev, layout, B, N, H, P, causal):
    # ragged N (partial query and key tiles), every prefix regime (none, one
    # token, one full tile, two tiles, a partial second tile), causal, odd
    # head counts, and the three layouts the attention module produces
    q, k, v = _nhd_inputs(dev, B, N, H, layout)
    before = [t.clone() for t in (q, k, v)]
    out = fa.flash_attention_nhd(q, k, v, causal=causal, prefix_len=P)
    want, want_lse = fa.flash_attention_nhd_plain(q, k, v, causal, P)
    assert out.shape == (B, N, H, 64) and out.is_contiguous()
    _close(out, want)
    for t, b in zip((q, k, v), before):
        assert torch.equal(t, b)
    _, lse = fa._launch_nhd(q, k, v, causal)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


def test_flash_attention_nhd_matches_prefix_entry(dev):
    # the same function as the [B, H, N, 64] entry on transposed copies
    q, k, v = _nhd_inputs(dev, 2, 1025, 4, "fused_views")
    out = fa.flash_attention_nhd(q, k, v, prefix_len=1)
    want, _ = fa.flash_attention_prefix(*(t.transpose(1, 2) for t in (q, k, v)), 1)
    _close(out, want.transpose(1, 2))


def test_flash_attention_nhd_gradients(dev):
    # the autograd Function on the card (NHD forward, the [B, H, N, 64]
    # backward kernels on transposed copies) against autograd through the
    # plain version: 2e-2 of each gradient's peak, as the flash backward
    fused = _randn(dev, 2, 130, 3 * 3 * 64, seed=1).requires_grad_()
    w = _randn(dev, 2, 130, 3, 64, seed=9)

    def grads(fn):
        q, k, v = (t.view(2, 130, 3, 64) for t in fused.chunk(3, dim=-1))
        return torch.autograd.grad((fn(q, k, v).float() * w.float()).sum(), fused)[0]

    got = grads(lambda q, k, v: fa.flash_attention_nhd(q, k, v, prefix_len=1))
    want = grads(lambda q, k, v: fa.flash_attention_nhd_plain(q, k, v, False, 1)[0])
    assert _rel_err(got, want) < 2e-2
    # the causal backward: the banded backward kernels under the causal mask
    q, k, v = (_randn(dev, 1, 70, 2, 64, seed=i).requires_grad_() for i in range(3))
    dout = _randn(dev, 1, 70, 2, 64, seed=5)
    got = torch.autograd.grad((fa.flash_attention_nhd(q, k, v, causal=True).float()
                               * dout.float()).sum(), (q, k, v))
    want = torch.autograd.grad((fa.flash_attention_nhd_plain(q, k, v, True)[0].float()
                                * dout.float()).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert _rel_err(a, b) < 2e-2


def test_flash_attention_nhd_raises_on_unreadable_input(dev):
    q = _randn(dev, 1, 70, 2, 64)
    with pytest.raises(TypeError):  # f32: the kernel takes bf16
        fa.flash_attention_nhd(q.float(), q.float(), q.float())
    t = _randn(dev, 1, 70, 64, 2).transpose(2, 3)  # last-axis stride 2
    with pytest.raises(ValueError, match="last-axis stride"):
        fa.flash_attention_nhd(t, q, q)
    odd = _randn(dev, 1, 70, 2 * 64 + 4)[..., 4:].view(1, 70, 2, 64)  # rows off 16 bytes
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_nhd(q, odd, q)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_nhd(*(_randn(dev, 1, 70, 2, 32),) * 3)
    with pytest.raises(ValueError, match="non-causal"):
        fa.flash_attention_nhd(q, q, q, causal=True, prefix_len=1)


# (B, H, N, D, causal, window): the LM's causal shapes cut in size, the TAAE
# windows at D = 128, one-sided and causal windows, ragged N, the unmasked
# function, a window wider than N
BAND_CASES = [
    (2, 3, 131, 64, True, None), (1, 2, 503, 64, True, None), (1, 2, 200, 128, True, None),
    (1, 2, 700, 128, False, (31, 32)), (1, 2, 520, 128, False, (63, 64)),
    (2, 1, 333, 64, False, (63, 64)), (1, 2, 257, 64, False, (16, -1)),
    (1, 2, 257, 128, False, (-1, 16)), (1, 3, 300, 64, True, (40, 7)),
    (1, 2, 190, 64, False, None), (1, 1, 100, 128, False, (500, 500))]


# the edges of csrc/flash_bwd.cu's tiles (64 rows; TMA boxes over
# [B*H, N, D]; lse / dsum boxes from 16-byte-aligned starts): lengths on
# either side of 64 and 128, D 64 and 128, windows whose edges straddle the
# tile boundaries, B*H > 1 with a ragged N (the cases of
# tests/test_torch_flash_bwd_tiles.py, which holds the plain version against
# the JAX kernels on the CPU)
TILE_CASES = [
    (1, 1, 63, 64, False, None), (2, 3, 65, 64, False, None), (1, 2, 64, 128, True, None),
    (2, 2, 127, 64, True, None), (1, 2, 128, 64, False, (63, 64)),
    (2, 1, 129, 128, False, (63, 64)), (1, 2, 257, 64, False, (127, 128)),
    (2, 1, 257, 128, True, (64, -1)), (3, 1, 129, 64, False, (16, -1)),
    (1, 2, 257, 64, False, (-1, 65)), (2, 2, 65, 128, False, (500, 500))]


@pytest.mark.parametrize("B,H,N,D,causal,window", BAND_CASES)
def test_flash_attention(dev, B, H, N, D, causal, window):
    q, k, v = (_randn(dev, B, H, N, D, seed=i) for i in range(3))
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal, window)
    assert out.shape == (B, H, N, D) and out.dtype == torch.bfloat16
    _close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    # strided operands: [B, H, N, D] views of [B, N, H, D] tensors, read as
    # they lie, give the same result
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert torch.equal(fa.flash_attention(*views, causal=causal, window=window)[0], out)


@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("B,H,N,D,causal,window", BAND_CASES + TILE_CASES)
def test_flash_attention_bwd_routes(dev, route, B, H, N, D, causal, window):
    # both backward routes under the band against the plain f32 backward:
    # 2e-2 of each gradient's peak, as the unmasked backward
    q, k, v, g = (_randn(dev, B, H, N, D, seed=i) for i in range(4))
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window)
    got = fa.flash_attention_prefix_bwd(q, k, v, out, lse, g, route=route, causal=causal,
                                        window=window)
    want = fa.flash_attention_prefix_bwd_plain(q, k, v, out, lse, g, causal, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all(), name
        assert _rel_err(a, b) < 2e-2, (name, _rel_err(a, b))


@pytest.mark.parametrize("B,H,N,D,causal,window", [(2, 3, 1025, 64, False, None),
                                                   (1, 2, 700, 128, False, (31, 32)),
                                                   (2, 4, 500, 64, True, None)])
def test_flash_bwd_two_pass_is_deterministic(dev, B, H, N, D, causal, window):
    # the training route adds no atomics: two runs give the same bits
    q, k, v, g = (_randn(dev, B, H, N, D, seed=i) for i in range(4))
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window)
    runs = [fa.flash_attention_prefix_bwd(q, k, v, out, lse, g, route="two_pass", causal=causal,
                                          window=window) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_flash_bwd_raises_on_misaligned_input(dev):
    # the kernels read their operands through TMA tensor maps, whose base
    # must lie on 16 bytes: a contiguous view 2 bytes in is refused
    q, k, v, g = (_randn(dev, 1, 2, 64, 64, seed=i) for i in range(4))
    out, lse = fa.flash_attention(q, k, v)
    buf = torch.empty(q.numel() + 1, device=dev, dtype=q.dtype)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_prefix_bwd(shifted, k, v, out, lse, g)


def test_flash_attention_gradients_on_card(dev):
    # the autograd Function (forward kernel, banded backward kernels) against
    # autograd through the plain version, 2e-2 of each gradient's peak
    for causal, window, D in ((True, None, 64), (False, (31, 32), 128)):
        q, k, v = (_randn(dev, 2, 2, 150, D, seed=i).requires_grad_() for i in range(3))
        dout = _randn(dev, 2, 2, 150, D, seed=7)
        got = torch.autograd.grad((fa.flash_attention(q, k, v, causal, window)[0].float()
                                   * dout.float()).sum(), (q, k, v))
        want = torch.autograd.grad((fa.flash_attention_plain(q, k, v, causal, window)[0]
                                    .float() * dout.float()).sum(), (q, k, v))
        for a, b in zip(got, want):
            assert _rel_err(a, b) < 2e-2


def test_flash_attention_raises_on_unreadable_input(dev):
    q = _randn(dev, 1, 2, 70, 64)
    with pytest.raises(TypeError):  # f32: the kernel takes bf16
        fa.flash_attention(q.float(), q.float(), q.float(), causal=True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*(_randn(dev, 1, 2, 70, 32),) * 3, causal=True)
    t = _randn(dev, 1, 2, 64, 70).transpose(2, 3)  # last-axis stride 70
    with pytest.raises(ValueError, match="last-axis stride"):
        fa.flash_attention(t, q, q, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_prefix_bwd(*(_randn(dev, 1, 2, 70, 96),) * 5,
                                      torch.zeros(1, 2, 70, device=dev))


# the edges of csrc/flash_fwd.cu's forward kernels (128-row blocks of two
# 64-row warpgroups, 128-key tiles, 4-D TMA maps over the caller's
# strides): lengths on either side of 64, 128 and
# 192, D 64 and 128, windows whose edges straddle the block edges, B*H > 1
# with a ragged N (the cases of tests/test_torch_flash_fwd_tiles.py, which
# holds the plain version against the JAX kernels on the CPU)
FWD_TILE_CASES = [
    (1, 1, 63, 64, False, None), (2, 3, 65, 64, False, None), (1, 2, 127, 128, True, None),
    (2, 2, 129, 64, True, None), (1, 2, 191, 64, False, (63, 64)),
    (2, 1, 193, 128, False, (127, 128)), (3, 1, 193, 64, True, (64, -1)),
    (1, 2, 257, 64, False, (-1, 65)), (2, 1, 255, 128, False, (16, -1)),
    (1, 1, 300, 64, False, (128, 0))]


@pytest.mark.parametrize("B,H,N,D,causal,window", FWD_TILE_CASES)
def test_flash_forward_tile_edges(dev, B, H, N, D, causal, window):
    q, k, v = (_randn(dev, B, H, N, D, seed=i) for i in range(3))
    out, lse = fa._launch_flash(q, k, v, causal, window)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal, window)
    _close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("B,N,H,P,layout", [(1, 1025, 2, 1, "fused_views"),
                                            (1, 6145, 2, 1, "fused_views"),
                                            (2, 193, 3, 0, "contiguous"),
                                            (2, 129, 2, 3, "fused_views")])
def test_flash_forward_nhd_tile_edges(dev, B, N, H, P, layout):
    # SA-Open's and SA-2.0's 1-token prefix at a narrow width, in the NHD
    # layout: views of one fused projection (three maps over one pointer)
    # or contiguous tensors
    fused = _randn(dev, B, N, 3 * H * 64, seed=5)
    q, k, v = (t.view(B, N, H, 64) for t in fused.chunk(3, dim=-1))
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, lse = fa._launch_nhd(q, k, v, False)
    want, want_lse = fa.flash_attention_nhd_plain(q, k, v, False, P)
    _close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("B,N,H,D,rot,causal,window", [
    (1, 129, 2, 64, 32, False, None), (2, 65, 2, 64, 64, True, None),
    (1, 193, 2, 128, 128, False, (63, 64)), (1, 127, 2, 128, 32, True, None),
    (2, 191, 1, 64, 32, False, (-1, 65))])
def test_flash_forward_fused_qkv_tile_edges(dev, B, N, H, D, rot, causal, window):
    # the rotary pass (rot_dim 32 and rot_dim = D) and the attention kernel
    qkv, cos, sin = _fused_inputs(dev, B, N, H, D, rot)
    out, lse = fa._launch_fused(qkv, cos, sin, H, causal, window)
    want, want_lse = fa.flash_attention_fused_qkv_plain(qkv, cos, sin, H, causal, window)
    _close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


# (B, N, H, D, rot_dim, causal, window): SA-2.0's rotary (32 of 64) unmasked
# with ragged N, the JAX test's cases (causal with rotary, window (63, 64)
# without, causal without), D = 128 with rotary 64 and with a full-width one,
# widths off the kernel's 16-byte table transfers (30) and bf16x2 pairs (36)
FUSED_CASES = [
    (2, 131, 3, 64, 32, False, None), (1, 257, 2, 64, 32, True, None),
    (1, 200, 2, 64, 0, False, (63, 64)), (2, 69, 2, 64, 0, True, None),
    (1, 130, 2, 128, 64, True, None), (1, 193, 1, 128, 128, False, None),
    (1, 1025, 4, 64, 32, False, None), (1, 150, 2, 64, 30, False, None),
    (1, 150, 2, 64, 36, True, (20, 5))]


def _fused_inputs(dev, B, N, H, D, rot):
    from stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs, rotary_tables

    qkv = _randn(dev, B, N, 3 * H * D, seed=11)
    cos, sin = rotary_tables(rotary_freqs(N, rot, device=dev)) if rot else (None, None)
    return qkv, cos, sin


@pytest.mark.parametrize("B,N,H,D,rot,causal,window", FUSED_CASES)
def test_flash_attention_fused_qkv(dev, B, N, H, D, rot, causal, window):
    # the kernel with the rotary in it against unpack + rotary + the plain
    # attention: 2 bf16 ulps, the logsumexp within 1e-3; the projection is
    # read as it lies and left as it was
    qkv, cos, sin = _fused_inputs(dev, B, N, H, D, rot)
    before = qkv.clone()
    out, lse = fa._launch_fused(qkv, cos, sin, H, causal, window)
    want, want_lse = fa.flash_attention_fused_qkv_plain(qkv, cos, sin, H, causal, window)
    assert out.shape == (B, N, H, D) and out.dtype == torch.bfloat16
    _close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    assert torch.equal(qkv, before)


def test_flash_attention_fused_qkv_matches_the_nhd_route(dev):
    # the same function as the rotary pass + `flash_attention_nhd` that
    # generation runs, at SA-2.0's head layout cut in length
    from stable_audio_tools_tpu_torch.ops.embeddings import apply_rotary_pos_emb_nhd, rotary_freqs

    qkv, cos, sin = _fused_inputs(dev, 2, 1025, 24, 64, 32)
    freqs = rotary_freqs(1025, 32, device=dev)
    q, k, v = (t.view(2, 1025, 24, 64) for t in qkv.chunk(3, dim=-1))
    want = fa.flash_attention_nhd(apply_rotary_pos_emb_nhd(q, freqs),
                                  apply_rotary_pos_emb_nhd(k, freqs), v, prefix_len=1)
    _close(fa.flash_attention_fused_qkv(qkv, cos, sin, 24), want)


def test_flash_attention_fused_qkv_gradients(dev):
    # the autograd Function on the card (the kernel forward; rotary re-run,
    # row 6's backward kernels and the rotary's VJP) against autograd through
    # the plain version: 2e-2 of the gradient's peak, as the flash backward
    for N, H, D, rot, causal, window in ((130, 3, 64, 32, False, None),
                                         (200, 2, 128, 64, True, None),
                                         (150, 2, 64, 0, False, (63, 64))):
        qkv, cos, sin = _fused_inputs(dev, 2, N, H, D, rot)
        qkv.requires_grad_()
        w = _randn(dev, 2, N, H, D, seed=9).float()
        got = torch.autograd.grad((fa.flash_attention_fused_qkv(
            qkv, cos, sin, H, causal, window).float() * w).sum(), qkv)[0]
        want = torch.autograd.grad((fa.flash_attention_fused_qkv_plain(
            qkv, cos, sin, H, causal, window)[0].float() * w).sum(), qkv)[0]
        assert got.dtype == torch.bfloat16 and _rel_err(got, want) < 2e-2


def test_flash_attention_fused_qkv_raises_on_unreadable_input(dev):
    qkv, cos, sin = _fused_inputs(dev, 1, 70, 2, 64, 32)
    with pytest.raises(TypeError):  # f32: the kernel takes bf16
        fa.flash_attention_fused_qkv(qkv.float(), cos, sin, 2)
    with pytest.raises(TypeError):  # bf16 tables: the kernel reads f32
        fa.flash_attention_fused_qkv(qkv, cos.bfloat16(), sin.bfloat16(), 2)
    with pytest.raises(ValueError, match="even width"):
        fa.flash_attention_fused_qkv(qkv, cos[:, :31].contiguous(), sin[:, :31].contiguous(), 2)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fused_qkv(_randn(dev, 1, 70, 3 * 4 * 32), None, None, 4)

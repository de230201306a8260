"""The fused-QKV flash attention of the port (`flash_attention_fused_qkv`,
rotary applied to q and k inside the kernel) against the JAX
`flash_attention_fused_qkv`, whose Pallas kernel runs in interpret mode on
the CPU, as tests/test_flash_attention.py runs it; and the `Attention`
dispatch that sends SA-2.0's training self-attention there.

On the CPU the port's wrapper takes its plain version
(`flash_attention_fused_qkv_plain`: unpack, rotary, `flash_attention_plain`)
and the backward its plain versions, so these tests hold the function the
CUDA kernel computes (tests/test_torch_cuda_kernels.py and chip_smoke.py hold
the kernel to the plain version on the card). The JAX entry reads the
interleaved projection [B, N, H, 3, D]; the port reads the concat layout
[B, N, 3*H*D], mapped with io/from_jax.py `deinterleave_fused`. Inputs are
f32 and made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.ops.embeddings import rotary_freqs as jax_rotary_freqs
from stable_audio_tools_tpu.ops.kernels import flash_attention as jfa
from stable_audio_tools_tpu_torch.io.from_jax import deinterleave_fused
from stable_audio_tools_tpu_torch.ops import attention as tattn
from stable_audio_tools_tpu_torch.ops.embeddings import (apply_rotary_pos_emb_nhd,
                                                          rotary_freqs, rotary_tables)
from stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tfa
from stable_audio_tools_tpu_torch.ops.transformer import ContinuousTransformer

# (causal, window, rot_dim, D, N): the four cases of the JAX test
# (tests/test_flash_attention.py:199, rotary 32 of 64), a ragged N (no
# multiple of the 64-row tile) with rotary, and D = 128 with a 64-wide rotary
CASES = [
    (True, None, 32, 64, 256),
    (False, None, 32, 64, 256),
    (False, (63, 64), 0, 64, 256),
    (True, None, 0, 64, 256),
    (False, None, 32, 64, 300),
    (True, None, 64, 128, 192),
]
H = 2


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _to_concat(qkv_jax: np.ndarray) -> np.ndarray:
    """[B, N, H, 3, D] interleaved -> [B, N, 3*H*D] concat ([q | k | v])."""
    B, N, heads, _, D = qkv_jax.shape
    flat = qkv_jax.reshape(B * N, heads * 3 * D)
    return deinterleave_fused(flat, 3, D).reshape(B, N, 3 * heads * D)


def _tables(N, rot):
    if rot == 0:
        return None, None
    cos, sin = rotary_tables(rotary_freqs(N, rot))
    return cos.numpy(), sin.numpy()


def _inputs(D, N, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((1, N, H, 3, D)).astype(np.float32)
    w = rng.standard_normal((1, N, H, D)).astype(np.float32)
    return qkv, w


def _jax_fused(qkv, cos, sin, causal, window):
    c = None if cos is None else jnp.asarray(cos)
    s = None if sin is None else jnp.asarray(sin)
    return jfa.flash_attention_fused_qkv(qkv, c, s, causal, window)


def _port_fused(qkv, cos, sin, causal, window):
    return tfa.flash_attention_fused_qkv(qkv, None if cos is None else _t(cos),
                                         None if sin is None else _t(sin), H, causal=causal,
                                         window=window)


@pytest.mark.parametrize("causal,window,rot,D,N", CASES)
def test_fused_qkv_plain_matches_pallas(causal, window, rot, D, N):
    # values within 2e-3, the JAX test's own tolerance (f32 on both sides)
    qkv, _ = _inputs(D, N, 0)
    cos, sin = _tables(N, rot)
    want = np.asarray(_jax_fused(jnp.asarray(qkv), cos, sin, causal, window))  # [B,H,N,D]
    got = _port_fused(_t(_to_concat(qkv)), cos, sin, causal, window)
    assert got.shape == (1, N, H, D)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 2, 1, 3), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("causal,window,rot,D,N", CASES)
def test_fused_qkv_gradient_matches_pallas(causal, window, rot, D, N):
    # d(qkv) of the port's autograd Function on the CPU (plain unpack and
    # rotary re-run, plain backward, the rotary's VJP) against jax.grad
    # through the Pallas forward and `_fused_bwd`, within 5e-3 (the JAX
    # test's tolerance)
    qkv, w = _inputs(D, N, 1)
    cos, sin = _tables(N, rot)
    wj = jnp.asarray(w.transpose(0, 2, 1, 3))

    def jax_loss(x):
        return jnp.sum(wj * _jax_fused(x, cos, sin, causal, window) ** 2)

    want = _to_concat(np.asarray(jax.grad(jax_loss)(jnp.asarray(qkv))))
    x = _t(_to_concat(qkv)).requires_grad_()
    out = _port_fused(x, cos, sin, causal, window)
    (got,) = torch.autograd.grad((_t(w) * out ** 2).sum(), x)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)


def test_rotary_tables_match_jax():
    # the cos / sin tables the port hands the kernel are the JAX test's
    # jnp.cos / jnp.sin of the JAX angle table (f32 transcendental ulps)
    cos, sin = rotary_tables(rotary_freqs(6145, 32))
    freqs = np.asarray(jax_rotary_freqs(6145, 32))
    assert cos.dtype == sin.dtype == torch.float32 and cos.shape == (6145, 32)
    np.testing.assert_allclose(cos.numpy(), np.cos(freqs), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.sin(freqs), atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_entry_equals_the_nhd_route(dtype):
    # the fused entry rotates the same positions as the rotary pass +
    # `flash_attention_nhd` route (all N rows, the prepended token first) and
    # rounds the rotated q, k to the input dtype as that pass does: the
    # two compute one function
    rng = np.random.default_rng(2)
    B, N, D = 2, 97, 64
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * D)).astype(np.float32)).to(dtype)
    freqs = rotary_freqs(N, 32)
    cos, sin = rotary_tables(freqs)
    got = tfa.flash_attention_fused_qkv(qkv, cos, sin, H)
    q, k, v = (t.view(B, N, H, D) for t in qkv.chunk(3, dim=-1))
    q, k = apply_rotary_pos_emb_nhd(q, freqs), apply_rotary_pos_emb_nhd(k, freqs)
    want = tfa.flash_attention_nhd(q, k, v, prefix_len=1)
    assert got.dtype == dtype
    # f32: reassociation of the two plain products; bf16: one unit in the
    # last place where the f32 results round apart
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7 * want.float().abs().max().item()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=0)


def _spy(monkeypatch):
    calls = []
    real = tattn.flash_attention_fused_qkv

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention_fused_qkv", spy)
    return calls


def _tiny_stack(use_checkpointing=True):
    torch.manual_seed(0)
    model = ContinuousTransformer(dim=128, depth=2, dim_in=16, dim_out=16, dim_heads=64,
                                  use_checkpointing=use_checkpointing)
    for layer in model.layers:
        layer.self_attn.nhd_min_seq = 32
    return model


@pytest.mark.parametrize("train,grad,fused", [(True, True, True), (True, False, False),
                                              (False, True, False)])
def test_training_forward_takes_the_fused_entry(monkeypatch, train, grad, fused):
    # only a training forward (training mode, grad enabled) of rotary
    # self-attention on the NHD route takes the fused entry; generation
    # (eval, or no grad) keeps the rotary pass + `flash_attention_nhd`
    calls = _spy(monkeypatch)
    model = _tiny_stack().train(train)
    x = torch.randn(1, 40, 16)
    with torch.set_grad_enabled(grad):
        model(x, prepend_embeds=torch.randn(1, 1, 128))
    assert len(calls) == (2 if fused else 0)


def test_short_and_causal_sequences_keep_their_routes(monkeypatch):
    # SA-Open's length (below `nhd_min_seq`) and the LM's causal stack take
    # `flash_attention_prefix` / `flash_attention` in training, as before
    calls = _spy(monkeypatch)
    model = _tiny_stack().train()
    for layer in model.layers:
        layer.self_attn.nhd_min_seq = 2048
    model(torch.randn(1, 40, 16), prepend_embeds=torch.randn(1, 1, 128)).sum().backward()
    causal = ContinuousTransformer(dim=128, depth=2, dim_in=16, dim_heads=64, causal=True,
                                   use_checkpointing=True).train()
    causal(torch.randn(1, 40, 16)).sum().backward()
    assert calls == []


def test_remat_training_gradients_equal_the_nhd_route():
    # a remat training step through the fused entry (forward and recomputed
    # forward, backward through the rotary's VJP) gives the gradients of the
    # same stack run on the NHD route (eval mode, grad enabled), f32
    model = _tiny_stack()
    x = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(3))
    prep = torch.randn(2, 1, 128, generator=torch.Generator().manual_seed(4))
    grads = []
    for train in (True, False):
        model.train(train)
        model.zero_grad()
        (model(x, prepend_embeds=prep) ** 2).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        ref = grads[1][name]
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=1e-5 * ref.abs().max().item())


def test_fused_entry_checks_its_arguments():
    qkv = torch.zeros(1, 10, 3 * H * 64)
    cos, sin = rotary_tables(rotary_freqs(10, 32))
    with pytest.raises(ValueError, match="both rotary tables"):
        tfa.flash_attention_fused_qkv(qkv, cos, None, H)
    with pytest.raises(ValueError, match="3 \\* 5"):
        tfa.flash_attention_fused_qkv(qkv, cos, sin, 5)
    # the launch path refuses what is not a bf16 CUDA tensor: no fallback
    with pytest.raises(ValueError, match="runs on CUDA"):
        tfa._launch_fused(qkv.bfloat16(), cos, sin, H, False, None)

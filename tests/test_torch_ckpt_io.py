"""The port's checkpoint I/O against the JAX package's (io/checkpoints.py):
`load_ckpt_state_dict` on torch checkpoints and `.safetensors` files in
F32 / F16 / BF16 (the port reads and writes the format itself: the card's
machine has no `safetensors` package), `copy_state_dict`,
`load_pretransform_state`, and `remove_weight_norm_from_model` on a tiny
Oobleck autoencoder with the JAX model's weights.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as torch_save_file

from stable_audio_tools_tpu.io import checkpoints as jck
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu_torch.io import checkpoints as tck
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from stable_audio_tools_tpu_torch.ops.conv import WNConvTranspose1d


def _tensors(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"a.weight": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
            "a.bias": torch.from_numpy(rng.standard_normal(5).astype(np.float32)),
            "b.scalar": torch.tensor(1.5), "c.empty": torch.zeros(0, 4),
            "d.count": torch.tensor([3, -7, 2 ** 40], dtype=torch.int64)}


def _as(sd: dict, dtype) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in sd.items()}


def _same_bits(port: dict, jax_sd: dict) -> None:
    """Every tensor of the port's result equals the JAX result's, widened to
    f32 (exact for F16 / BF16) or as integers."""
    assert port.keys() == jax_sd.keys()
    for k, v in port.items():
        want = np.asarray(jax_sd[k])
        got = v.float().numpy() if v.is_floating_point() else v.numpy()
        assert got.shape == want.shape, k
        if v.is_floating_point():
            np.testing.assert_array_equal(got, want.astype(np.float32), err_msg=k)
        else:
            np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("wrapped", [True, False])
def test_torch_checkpoint_reads_as_jax(tmp_path, dtype, wrapped):
    # a torch.save file with or without `state_dict`: the port's floats come
    # back as f32, as the JAX reader's, bit for bit
    sd = _as(_tensors(), dtype)
    path = str(tmp_path / "m.ckpt")
    torch.save({"state_dict": sd, "step": 3} if wrapped else sd, path)
    got = tck.load_ckpt_state_dict(path)
    assert all(v.dtype == torch.float32 for v in got.values() if v.is_floating_point())
    want = jck.load_ckpt_state_dict(path)
    _same_bits(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reads_as_jax(tmp_path, dtype):
    # files written by the safetensors package (numpy for F32 / F16, torch for
    # BF16, which numpy lacks); the port keeps the stored dtype
    sd = _as(_tensors(1), dtype)
    path = str(tmp_path / "m.safetensors")
    if dtype == torch.bfloat16:
        torch_save_file(sd, path)
    else:
        np_save_file({k: v.numpy() for k, v in sd.items()}, path)
    got = tck.load_ckpt_state_dict(path)
    assert {k: v.dtype for k, v in got.items()} == {k: v.dtype for k, v in sd.items()}
    _same_bits(got, jck.load_ckpt_state_dict(path))
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int32])
def test_safetensors_writer_round_trips_through_jax(tmp_path, dtype):
    sd = {k: v.to(dtype) if v.is_floating_point() else v for k, v in _tensors(2).items()}
    sd["e.view"] = torch.arange(24, dtype=torch.float32).reshape(4, 6)[:, 1:4].to(dtype)
    path = str(tmp_path / "w.safetensors")
    tck.save_safetensors(path, sd, metadata={"model_config": json.dumps({"x": 1})})
    for k, v in tck.load_safetensors(path).items():
        assert v.dtype == sd[k].dtype and torch.equal(v, sd[k]), k
    _same_bits(tck.load_ckpt_state_dict(path), jck.load_ckpt_state_dict(path))
    with safe_open(path, "pt") as f:  # the reference reader
        assert json.loads(f.metadata()["model_config"]) == {"x": 1}
        for k in sd:
            assert torch.equal(f.get_tensor(k), sd[k]), k


def test_copy_state_dict_matches_by_name_and_shape():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    sd = {"0.weight": torch.ones(4, 3), "0.bias": torch.full((4,), 2.0, dtype=torch.float64),
          "1.weight": torch.ones(3, 3), "2.weight": torch.ones(1)}
    loaded, skipped = tck.copy_state_dict(model, sd)
    assert loaded == 2 and skipped == ["1.weight", "2.weight"]
    assert torch.equal(model[0].weight, torch.ones(4, 3))
    assert model[0].bias.dtype == torch.float32
    assert torch.equal(model[0].bias, torch.full((4,), 2.0))


OOBLECK = {"channels": 8, "c_mults": [2, 4], "strides": [2, 4], "use_snake": True}
AE_CONFIG = {
    "model_type": "autoencoder", "sample_rate": 16000,
    "model": {"encoder": {"type": "oobleck", "config": dict(OOBLECK, in_channels=2,
                                                            latent_dim=8)},
              "decoder": {"type": "oobleck", "config": dict(OOBLECK, out_channels=2,
                                                            latent_dim=4)},
              "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
              "io_channels": 2},
}


@pytest.fixture(scope="module")
def ae_pair():
    """(JAX autoencoder, its params, the port's with the same weights), the
    weight-norm gains drawn away from ||v|| (as trained weights are)."""
    model = jax_create(AE_CONFIG)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, 2, 64))))
    rng = np.random.default_rng(3)

    def draw(path, a):
        name = path[-1].key
        if name == "g":
            return (1 + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        std = np.prod(a.shape[:-1]) ** -0.5 if len(a.shape) >= 2 else 0.1
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    port = create_model_from_config(AE_CONFIG, "cpu")
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          from_jax.autoencoder_state_dict(params).items()}, strict=True)
    return model, params, port.eval()


def test_remove_weight_norm_matches_jax(ae_pair):
    # every weight-normalised conv of the tiny Oobleck: the port's v and g
    # after the removal against the JAX function's, 1e-6 relative. The JAX
    # function re-normalises a transposed conv only where its gain's length
    # equals its output channels (the flax layout's last axis), which the
    # Oobleck's upsampling convs (in = 2 out) never meet: it leaves them as
    # they are. The port re-normalises them as the reference's
    # remove_weight_norm does; their weight stays the same and g = ||v||.
    model, params, port = ae_pair
    port = create_model_from_config(AE_CONFIG, "cpu")
    port.load_state_dict(ae_pair[2].state_dict())
    before = {k: v.clone() for k, v in port.state_dict().items()}
    n = tck.remove_weight_norm_from_model(port)
    want = from_jax.autoencoder_state_dict(
        jax.tree_util.tree_map(np.asarray, jck.remove_weight_norm_from_model(params)))
    got = port.state_dict()
    transposed = {name for name, m in port.named_modules() if isinstance(m, WNConvTranspose1d)}
    assert n == sum(k.endswith(".weight_g") for k in got) and transposed
    for k, v in got.items():
        layer = k.rsplit(".", 1)[0]
        if k.endswith((".weight_v", ".weight_g")) and layer in transposed:
            np.testing.assert_array_equal(want[k], before[k].numpy(), err_msg=k)  # JAX: as it was
            continue
        ref = want[k]
        np.testing.assert_allclose(v.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=k)
    for layer in transposed:
        v, g = got[f"{layer}.weight_v"], got[f"{layer}.weight_g"]
        w0 = before[f"{layer}.weight_v"] * before[f"{layer}.weight_g"] / torch.linalg.vector_norm(
            before[f"{layer}.weight_v"], dim=(1, 2), keepdim=True)
        torch.testing.assert_close(v, w0, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(g, torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True),
                                   rtol=1e-6, atol=0)


def test_remove_weight_norm_leaves_the_decode(ae_pair):
    # the tiny Oobleck's decode of seeded latents before and after: f32, the
    # weights recomposed through one more norm, 1e-5 of the peak
    port = create_model_from_config(AE_CONFIG, "cpu")
    port.load_state_dict(ae_pair[2].state_dict())
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 4, 16)).astype(np.float32))
    with torch.no_grad():
        want = port.decode(z)
        tck.remove_weight_norm_from_model(port)
        got = port.decode(z)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_pretransform_state_refuses_a_missing_tensor(ae_pair, tmp_path):
    from test_torch_slice import CONFIG

    model = create_model_from_config(CONFIG, "cpu")
    ae = model.pretransform.model.state_dict()
    sd = {k: torch.randn_like(v) for k, v in ae.items()}
    assert tck.load_pretransform_state(model, sd) == len(ae)
    for k, v in model.pretransform.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # a whole model's file: its pretransform.model.* part is taken
    whole = {f"pretransform.model.{k}": v + 1 for k, v in sd.items()}
    whole["model.model.other"] = torch.zeros(1)
    tck.load_pretransform_state(model, whole)
    assert torch.equal(model.pretransform.model.state_dict()[next(iter(ae))],
                       sd[next(iter(ae))] + 1)
    missing = dict(sd)
    dropped = sorted(missing)[3]
    del missing[dropped]
    with pytest.raises(RuntimeError, match="lacks 1 tensors"):
        tck.load_pretransform_state(model, missing)
    wrong = dict(sd)
    wrong[dropped] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="1 of another shape"):
        tck.load_pretransform_state(model, wrong)
    with pytest.raises(ValueError, match="no pretransform"):
        tck.load_pretransform_state(torch.nn.Linear(1, 1), sd)

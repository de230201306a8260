"""The port's other pretransforms against the JAX package on the CPU: the
wavelet banks (every designed order pinned to the JAX package's four
arrays), the DWT / IDWT, the PQMF bank, patching, each type built from a
config by both factories, and the public codecs (`dac_pretrained`,
`audiocraft_pretrained`, at narrow custom widths) through encode / decode /
tokenize / decode_tokens, their weights saved by the port to a checkpoint
that both packages load through `ckpt_path` / `inject_pretransform_ckpt`,
and carried back by io/from_jax.py.

Inputs are made from a seed with numpy; f32 throughout. Bounds, each stated
where it is used: the filter banks bit for bit; the transforms 1e-5 of the
output's peak (one grouped conv a level, summed in another order); the
codecs 1e-5 of the peak, their codes exactly; the DAC codec in bf16 (the
card's) 5% in relative L2, 90% of its codes.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.models import pqmf as jpqmf
from stable_audio_tools_tpu.models import wavelets as jwav
from stable_audio_tools_tpu.models.factory import create_pretransform_from_config as jax_create_pt
from stable_audio_tools_tpu.models.handle import inject_pretransform_ckpt
from stable_audio_tools_tpu_torch.io.checkpoints import codec_state_dict
from stable_audio_tools_tpu_torch.io.from_jax import autoencoder_state_dict
from stable_audio_tools_tpu_torch.models import pqmf as tpqmf
from stable_audio_tools_tpu_torch.models import wavelets as twav
from stable_audio_tools_tpu_torch.models.factory import (create_model_from_config,
                                                         create_pretransform_from_config,
                                                         init_random_)
from test_torch_ae_training import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# every order the JAX package designs (spline bior / rbio, Daubechies) and the embedded banks
DESIGNED = ([f"{fam}{nr}.{nd}" for fam in ("bior", "rbio")
             for nr, nds in ((1, (1, 3, 5)), (2, (2, 4, 6, 8)), (3, (1, 3, 5, 7, 9)))
             for nd in nds]
            + [f"db{n}" for n in range(1, 21)]
            + ["haar", "bior4.4", "rbio4.4", "cdf97", "legall53"])


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("wavelet", DESIGNED)
def test_filter_bank_is_the_jax_packages(wavelet):
    # the first perfect-reconstruction alignment of the JAX search, for every order
    got, want = twav.get_filter_bank(wavelet), jwav.get_filter_bank(wavelet)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_unsupported_wavelets_raise_as_in_jax():
    for bad in ("bior5.5", "bior6.8", "sym5", "coif3", "db21", "nope"):
        with pytest.raises(ValueError):
            jwav.get_filter_bank(bad)
        with pytest.raises(ValueError):
            twav.get_filter_bank(bad)


@pytest.mark.parametrize("wavelet", ["haar", "db4", "db20", "bior4.4", "bior2.2", "bior3.5",
                                     "bior1.3", "rbio3.5"])
def test_wavelet_encode_decode_match_jax(wavelet):
    x = np.random.default_rng(0).standard_normal((2, 2, 128)).astype(np.float32)
    z = twav.wavelet_encode(torch.from_numpy(x), wavelet, 3)
    zj = np.asarray(jwav.wavelet_encode(jnp.asarray(x), wavelet, 3))
    assert z.shape == zj.shape == (2, 16, 16)
    assert _rel(z.numpy(), zj) < 1e-5
    y = twav.wavelet_decode(z, wavelet, 3)
    yj = np.asarray(jwav.wavelet_decode(jnp.asarray(zj), wavelet, 3))
    assert _rel(y.numpy(), yj) < 1e-5
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)  # perfect reconstruction


@pytest.mark.parametrize("bands,length", [(16, 2048), (4, 510)])
def test_pqmf_matches_jax(bands, length):
    assert np.array_equal(tpqmf.design_pqmf(100, bands), jpqmf.design_pqmf(100, bands))
    x = np.random.default_rng(1).standard_normal((1, 2, length)).astype(np.float32)
    z = tpqmf.pqmf_analysis(torch.from_numpy(x), 100, bands)
    zj = np.asarray(jpqmf.pqmf_analysis(jnp.asarray(x), 100, bands))
    assert z.shape == zj.shape == (1, 2 * bands, length // bands)
    assert _rel(z.numpy(), zj) < 1e-5
    y = tpqmf.pqmf_synthesis(z, 100, bands)
    yj = np.asarray(jpqmf.pqmf_synthesis(jnp.asarray(zj), 100, bands))
    assert y.shape == yj.shape
    assert _rel(y.numpy(), yj) < 1e-5


SIGNAL_CONFIGS = {
    "patched": ({"type": "patched", "config": {"patch_size": 4, "io_channels": 2}}, 2),
    "wavelet_bior4.4": ({"type": "wavelet", "config": {"channels": 2, "levels": 3,
                                                       "wavelet": "bior4.4"}}, 2),
    "wavelet_bior3.5": ({"type": "wavelet", "config": {"channels": 1, "levels": 2,
                                                       "wavelet": "bior3.5"}}, 1),
    "pqmf": ({"type": "pqmf", "config": {"attenuation": 100, "num_bands": 8}}, 2),
}


@pytest.mark.parametrize("name", sorted(SIGNAL_CONFIGS))
def test_signal_pretransforms_from_config_match_jax(name):
    config, channels = SIGNAL_CONFIGS[name]
    pt = create_pretransform_from_config(config, 16000, "cpu")
    jpt = jax_create_pt(config, 16000)
    for attr in ("io_channels", "encoded_channels", "downsampling_ratio", "enable_grad"):
        assert getattr(pt, attr) == getattr(jpt, attr), attr
    assert not pt.is_discrete and not list(pt.parameters())
    x = np.random.default_rng(2).standard_normal((2, channels, 512)).astype(np.float32)
    z = pt.encode(torch.from_numpy(x))
    zj = np.asarray(jpt.apply({}, jnp.asarray(x), method=jpt.encode))
    assert z.shape == zj.shape and _rel(z.numpy(), zj) < 1e-5
    y = pt.decode(z)
    yj = np.asarray(jpt.apply({}, jnp.asarray(zj), method=jpt.decode))
    assert y.shape == yj.shape == x.shape and _rel(y.numpy(), yj) < 1e-5


CODEC_CONFIGS = {
    # a custom DAC: the towers at d_model 16, strides 2 / 4 (ratio 8, latent
    # 64), decoder 32 channels, 3 codebooks of 16
    "dac_pretrained": ({"type": "dac_pretrained", "config": {
        "model_type": "custom", "strides": [2, 4], "d_model": 16, "latent_dim": 64,
        "channels": 32, "n_codebooks": 3, "codebook_size": 16}}, 16000),
    # a custom EnCodec: SEANet of 8 filters, ratios 4 / 2, dimension 16, 2 x 32 codes
    "audiocraft_pretrained": ({"type": "audiocraft_pretrained", "config": {
        "model_type": "custom", "ratios": [4, 2], "n_filters": 8, "dimension": 16,
        "num_quantizers": 2, "codebook_size": 32}}, 32000),
}


def _jax_codec_variables(jpt, path):
    """The JAX codec's variables, loaded from `path` by the JAX package's
    `inject_pretransform_ckpt` (its collections' `pretransform` subtrees)."""
    owner = types.SimpleNamespace(pretransform=jpt)
    return {col: tree["pretransform"]
            for col, tree in inject_pretransform_ckpt(owner, {}, str(path)).items()}


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    """name -> (the port's random codec, the port's codec loaded from its
    checkpoint by `ckpt_path`, the JAX codec and its variables from the same
    file)."""
    out = {}
    for i, (name, (config, sr)) in enumerate(sorted(CODEC_CONFIGS.items())):
        pt = create_pretransform_from_config(config, sr, "cpu")
        init_random_(pt, torch.Generator().manual_seed(i))
        with torch.no_grad():  # a random DAC decoder's gains grow the f32 differences
            for n, p in pt.model.decoder.named_parameters():  # into its tanh: halve them
                if n.endswith("weight_g"):
                    p.mul_(0.5)
        path = tmp_path_factory.mktemp(name) / "codec.pt"
        torch.save(codec_state_dict(pt.model), path)
        loaded = create_pretransform_from_config(
            {**config, "config": {**config["config"], "ckpt_path": str(path)}}, sr, "cpu")
        jpt = jax_create_pt({**config, "config": {**config["config"], "ckpt_path": str(path)}},
                            sr)
        out[name] = (pt.eval(), loaded.eval(), jpt, _jax_codec_variables(jpt, path))
    return out


@pytest.mark.parametrize("name", sorted(CODEC_CONFIGS))
def test_codec_pretransform_attributes_match_jax(name):
    config, sr = CODEC_CONFIGS[name]
    pt = create_pretransform_from_config(config, sr, "meta")
    jpt = jax_create_pt(config, sr)
    for attr in ("io_channels", "encoded_channels", "downsampling_ratio", "is_discrete",
                 "num_quantizers", "codebook_size", "chunked", "scale"):
        assert getattr(pt, attr) == getattr(jpt, attr), attr


@pytest.mark.parametrize("name", sorted(CODEC_CONFIGS))
def test_codec_checkpoint_loads_alike_in_both_packages(codecs, name):
    # the port's state dict, saved in the codec's own layout, loaded by the
    # port (ckpt_path) and by the JAX package (inject_pretransform_ckpt):
    # the same encode, codes and decode
    pt, loaded, jpt, jvars = codecs[name]
    for (n, a), (m, b) in zip(pt.state_dict().items(), loaded.state_dict().items()):
        assert n == m, n
        if n.endswith("initted"):  # a loaded codebook counts as initialised, as in JAX
            assert bool(b)
        else:
            assert torch.equal(a, b), n
    x = (0.5 * np.random.default_rng(3).standard_normal((2, 1, 512))).astype(np.float32)
    with torch.no_grad():
        z = loaded.encode(torch.from_numpy(x))
        codes = loaded.tokenize(torch.from_numpy(x))
        y = loaded.decode(z)
        y_tok = loaded.decode_tokens(codes)
    zj = np.asarray(jpt.apply(jvars, jnp.asarray(x), method=jpt.encode))
    cj = np.asarray(jpt.apply(jvars, jnp.asarray(x), method=jpt.tokenize))
    yj = np.asarray(jpt.apply(jvars, jnp.asarray(zj), method=jpt.decode))
    ytj = np.asarray(jpt.apply(jvars, jnp.asarray(cj), method=jpt.decode_tokens))
    assert z.shape == zj.shape and _rel(z.numpy(), zj) < 1e-5
    assert codes.shape == cj.shape == (2, jpt.num_quantizers, 512 // jpt.downsampling_ratio)
    np.testing.assert_array_equal(codes.numpy(), cj)
    assert y.shape == yj.shape == x.shape and _rel(y.numpy(), yj) < 1e-5
    assert _rel(y_tok.numpy(), ytj) < 1e-5


# the DAC codec in bf16 (what the factory builds on the card) against the JAX
# package's f32: relative L2 distance of the latents and of the audio decoded
# from the JAX package's own latents and codes, and the share of codes that
# agree (bf16 latents move a near-tied code)
DAC_BF16_REL, DAC_BF16_CODES = 5e-2, 0.9


def test_dac_codec_in_bf16_holds_to_jax_f32(codecs):
    _, loaded, jpt, jvars = codecs["dac_pretrained"]
    half = copy.deepcopy(loaded)
    half.model_half = True
    x = (0.5 * np.random.default_rng(5).standard_normal((2, 1, 512))).astype(np.float32)
    zj = jpt.apply(jvars, jnp.asarray(x), method=jpt.encode)
    cj = jpt.apply(jvars, jnp.asarray(x), method=jpt.tokenize)
    with torch.no_grad():
        z = half.encode(torch.from_numpy(x))
        codes = half.tokenize(torch.from_numpy(x))
        y = half.decode(torch.from_numpy(np.array(zj)))
        y_tok = half.decode_tokens(torch.from_numpy(np.array(cj)))
    assert z.dtype == y.dtype == y_tok.dtype == torch.float32

    def rel2(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    assert rel2(z, zj) < DAC_BF16_REL
    assert rel2(y, jpt.apply(jvars, zj, method=jpt.decode)) < DAC_BF16_REL
    assert rel2(y_tok, jpt.apply(jvars, cj, method=jpt.decode_tokens)) < DAC_BF16_REL
    assert (codes.numpy() == np.asarray(cj)).mean() >= DAC_BF16_CODES


@pytest.mark.parametrize("name", sorted(CODEC_CONFIGS))
def test_codec_weights_carried_back_by_from_jax(codecs, name):
    # the JAX codec's variables through io/from_jax.py into a fresh port
    # codec: the same encode and decode as the JAX package's
    _, _, jpt, jvars = codecs[name]
    config, sr = CODEC_CONFIGS[name]
    port = create_pretransform_from_config(config, sr, "cpu").eval()
    tree = jax.tree_util.tree_map(np.asarray, jvars)
    sd = autoencoder_state_dict(tree["params"]["model"],
                                quantizer_state=tree.get("quantizer_state", {}).get("model"))
    port.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                               strict=True)
    x = (0.5 * np.random.default_rng(4).standard_normal((1, 1, 256))).astype(np.float32)
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x))
        y = port.decode(z)
    zj = np.asarray(jpt.apply(jvars, jnp.asarray(x), method=jpt.encode))
    yj = np.asarray(jpt.apply(jvars, jnp.asarray(zj), method=jpt.decode))
    assert _rel(z.numpy(), zj) < 1e-5 and _rel(y.numpy(), yj) < 1e-5


def test_codec_checkpoint_without_its_codebooks_is_refused(tmp_path):
    config, sr = CODEC_CONFIGS["audiocraft_pretrained"]
    pt = create_pretransform_from_config(config, sr, "cpu")
    sd = {k: v for k, v in codec_state_dict(pt.model).items() if not k.startswith("quantizer.")}
    torch.save(sd, tmp_path / "codec.pt")
    with pytest.raises(RuntimeError, match="lacks"):
        create_pretransform_from_config(
            {**config, "config": {**config["config"], "ckpt_path": str(tmp_path / "codec.pt")}},
            sr, "cpu")


def test_public_codec_architectures_build_at_published_size():
    # DAC 44 kHz and MusicGen's EnCodec 32 kHz on the meta device: ratios,
    # widths and codebooks of the JAX factory's tables
    dac = create_pretransform_from_config({"type": "dac_pretrained", "config": {}}, 44100, "meta")
    jdac = jax_create_pt({"type": "dac_pretrained", "config": {}}, 44100)
    assert (dac.downsampling_ratio, dac.encoded_channels, dac.num_quantizers,
            dac.codebook_size, dac.chunked) == (jdac.downsampling_ratio, jdac.encoded_channels,
                                                jdac.num_quantizers, jdac.codebook_size,
                                                jdac.chunked) == (512, 1024, 9, 1024, True)
    assert dac.model.bottleneck.quantize_on_decode
    assert not dac.model_half  # bf16 on the card alone; f32 elsewhere, as the JAX package
    enc = create_pretransform_from_config({"type": "audiocraft_pretrained", "config": {}},
                                          32000, "meta")
    assert (enc.downsampling_ratio, enc.encoded_channels, enc.num_quantizers,
            enc.codebook_size) == (640, 128, 4, 2048)
    assert not enc.model_half
    assert all(u.shortcut is None for u in enc.model.encoder.modules()
               if hasattr(u, "shortcut"))  # true_skip: identity skips
    with pytest.raises(ValueError, match="custom DAC"):
        create_pretransform_from_config({"type": "dac_pretrained",
                                         "config": {"model_type": "48khz"}}, 48000, "meta")


@pytest.mark.parametrize("key", ["antialias_activation", "use_nearest_upsample"])
def test_oobleck_options_not_ported_are_refused_by_name(key):
    from test_torch_slice import CONFIG

    config = {"model_type": "autoencoder", "sample_rate": 16000,
              "model": dict(CONFIG["model"]["pretransform"]["config"])}
    side = "decoder" if key == "use_nearest_upsample" else "encoder"
    config["model"][side] = {"type": "oobleck",
                             "config": {**config["model"][side]["config"], key: True}}
    with pytest.raises(NotImplementedError, match=key):
        create_model_from_config(config, "meta")
    config["model"][side]["config"][key] = False  # off is the built model
    create_model_from_config(config, "meta")

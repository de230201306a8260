"""The weight converter (io/from_jax.py) against the JAX package's own
mappings: its DiT export (io/torch_mapping.py::export_dit_state_dict), its
de-interleaving helpers, and its importers of reference torch checkpoints,
which must read the port's names back into the original flax parameters.
All comparisons are exact: the converter only transposes and reshapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.io import checkpoints as jck
from stable_audio_tools_tpu.io import torch_mapping as jtm
from stable_audio_tools_tpu.models.dit import DiffusionTransformer as JaxDiT
from stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from stable_audio_tools_tpu_torch.io import from_jax
from stable_audio_tools_tpu_torch.models import t5 as tt5
from stable_audio_tools_tpu_torch.models.factory import create_model_from_config

DIT_KW = dict(io_channels=8, embed_dim=128, depth=2, num_heads=2, cond_token_dim=64,
              global_cond_dim=128, project_cond_tokens=False)


def _np_tree(tree, seed=0):
    """numpy copy of a flax tree with seeded values (no two leaves alike)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


def _dit_params():
    jm = JaxDiT(use_checkpointing=False, **DIT_KW)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)), jnp.ones((1,)),
        cross_attn_cond=jnp.zeros((1, 5, 64)), global_embed=jnp.zeros((1, 128))))
    return _np_tree(shapes["params"])


@pytest.mark.parametrize("n_fused", [2, 3])
def test_deinterleave_fused_matches_jax(n_fused):
    k = np.random.default_rng(n_fused).standard_normal((48, n_fused * 4 * 16))
    np.testing.assert_array_equal(from_jax.deinterleave_fused(k, n_fused, 16),
                                  jtm._deinterleave_fused(k, n_fused, 16))
    np.testing.assert_array_equal(jtm._interleave_fused(from_jax.deinterleave_fused(
        k, n_fused, 16), n_fused, 16), k)


def test_deinterleave_glu_matches_jax():
    k = np.random.default_rng(0).standard_normal((48, 2 * 40))
    b = k[0]
    np.testing.assert_array_equal(from_jax.deinterleave_glu(k), jtm._deinterleave_glu(k))
    np.testing.assert_array_equal(from_jax.deinterleave_glu(b), jtm._deinterleave_glu(b))
    np.testing.assert_array_equal(jtm._interleave_glu(from_jax.deinterleave_glu(k)), k)


def test_dit_state_dict_matches_export_dit_state_dict():
    p = _dit_params()
    got = from_jax.dit_state_dict(p, dim_heads=64, prefix="model.model.")
    want = jtm.export_dit_state_dict(p, "model.model.", dim_heads=64)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # and the names are exactly the port's DiT's
    from stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer

    port_names = {f"model.model.{k}" for k in DiffusionTransformer(**DIT_KW).state_dict()}
    assert port_names == set(got)


def test_dit_state_dict_imports_back_through_jax_importer():
    p = _dit_params()
    sd = from_jax.dit_state_dict(p, dim_heads=64, prefix="model.model.")
    back = jtm.import_dit(sd, "model.model.", depth=2, cross_attend=True, dim_heads=64)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, p)


OOBLECK = {"type": "oobleck", "config": {"channels": 8, "c_mults": [1, 2], "strides": [2, 4],
                                         "use_snake": True}}
AE_CONFIG = {
    "model_type": "autoencoder", "sample_rate": 16000,
    "model": {
        "encoder": {"type": "oobleck", "config": dict(OOBLECK["config"], in_channels=2,
                                                      latent_dim=8)},
        "decoder": {"type": "oobleck", "config": dict(OOBLECK["config"], out_channels=2,
                                                      latent_dim=4)},
        "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
        "io_channels": 2,
    },
}


def test_autoencoder_state_dict_imports_back_through_jax_importer():
    model = jax_create(AE_CONFIG)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, 2, 64))))
    p = _np_tree(shapes["params"])
    sd = from_jax.autoencoder_state_dict(p)
    back = jck.import_autoencoder_state_dict(model, sd)["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, back), p)
    # the port's autoencoder has exactly these names and shapes
    port = create_model_from_config(AE_CONFIG, "cpu")
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)


def test_t5_names_are_hugging_face_names():
    # the port's T5 loads a Hugging Face T5EncoderModel state dict by name
    # (all but the tied `encoder.embed_tokens` alias) and computes the same
    # function: 1e-5 on f32 outputs
    from transformers import T5Config, T5EncoderModel

    cfg = T5Config(d_model=32, d_ff=64, num_layers=2, num_heads=2, d_kv=16, vocab_size=300,
                   feed_forward_proj="gated-gelu", is_encoder_decoder=False)
    torch.manual_seed(0)
    hf = T5EncoderModel(cfg).eval()
    sd = {k: v for k, v in hf.state_dict().items() if k != "encoder.embed_tokens.weight"}
    port = tt5.T5EncoderModel(tt5.T5Arch(32, 64, 2, 2, 16, True, vocab_size=300))
    port.load_state_dict(sd, strict=True)
    ids = torch.randint(0, 300, (2, 20), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 20, dtype=torch.long)
    mask[0, 12:] = 0
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = port.eval()(ids, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)

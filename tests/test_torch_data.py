"""The port's data pipeline (data/) against the JAX package's on the same WAV
files: WAV bytes, crops, channel handling, metadata, padding masks, the
random crop and phase flip from the same `random` state, resampling,
loudness, and the DataLoader's batches. Inputs are made from a seed with
numpy; tolerances are stated where they are not exact."""

import os
import random

import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.data import dataset as jds
from stable_audio_tools_tpu.data import resample as jresample
from stable_audio_tools_tpu.data import utils as jutils
from stable_audio_tools_tpu.data import wav as jwav
from stable_audio_tools_tpu_torch.data import dataset as tds
from stable_audio_tools_tpu_torch.data import resample as tresample
from stable_audio_tools_tpu_torch.data import utils as tutils
from stable_audio_tools_tpu_torch.data import wav as twav

SR = 44100
SAMPLE_SIZE = 4096
META_MODULE = '''
def get_custom_metadata(info, audio):
    return {"prompt": "clip " + info["relpath"], "peak": float(abs(audio).max())}
'''


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """Stereo longer than a crop, mono shorter, 3 channels, float32, in a
    subfolder; plus a custom metadata module."""
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    clips = {"long.wav": (2, 3 * SAMPLE_SIZE + 17, False),
             "short_mono.wav": (1, SAMPLE_SIZE // 3, False),
             "three.wav": (3, SAMPLE_SIZE + 5, False),
             "sub/float.wav": (2, 2 * SAMPLE_SIZE, True)}
    for name, (c, n, f32) in clips.items():
        os.makedirs(os.path.dirname(root / name), exist_ok=True)
        twav.save_wav(str(root / name), 0.5 * rng.standard_normal((c, n)), SR, float32=f32)
    module = root.parent / f"{root.name}_meta.py"
    module.write_text(META_MODULE)
    return str(root), str(module)


@pytest.mark.parametrize("float32", [False, True])
def test_wav_bytes_and_reads_match_jax(tmp_path, float32):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 1000)).astype(np.float32)
    twav.save_wav(str(tmp_path / "t.wav"), x, SR, float32=float32)
    jwav.save_wav(str(tmp_path / "j.wav"), x, SR, float32=float32)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = twav.load_wav(str(tmp_path / "j.wav"))
    want, jsr = jwav.load_wav(str(tmp_path / "t.wav"))
    assert sr == jsr == SR
    np.testing.assert_array_equal(got, want)


def _datasets(audio_dir, **kw):
    root, module = audio_dir
    configs = [{"id": "a", "path": root, "custom_metadata_module": module}]
    kw = dict(sample_size=SAMPLE_SIZE, sample_rate=SR, force_channels="stereo", **kw)
    return tds.SampleDataset(configs, **kw), jds.SampleDataset(configs, **kw)


def _assert_items_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float32 and got[0].shape == (2, SAMPLE_SIZE)
    assert set(got[1]) == set(want[1])
    for key, value in want[1].items():
        np.testing.assert_array_equal(np.asarray(got[1][key]), np.asarray(value), err_msg=key)


def test_sample_dataset_matches_jax(audio_dir):
    # first crops (random_crop=False), no phase flip: every item and every
    # metadata field (timestamps, seconds, padding mask, custom metadata) equal
    port, ref = _datasets(audio_dir, random_crop=False, augment_phase=False)
    assert sorted(port.filenames) == sorted(ref.filenames) and len(port) == 4
    for i in range(len(port)):
        j = ref.filenames.index(port.filenames[i])
        _assert_items_equal(port[i], ref[j])
    short = port[port.filenames.index(os.path.join(audio_dir[0], "short_mono.wav"))]
    assert short[1]["padding_mask"].sum() == SAMPLE_SIZE // 3
    np.testing.assert_array_equal(short[0][0], short[0][1])  # mono -> both channels


def test_random_crop_and_phase_flip_follow_the_same_draws(audio_dir):
    # both pipelines draw their crop offset and phase flip from Python's
    # `random`: from the same state they make the same choices
    port, ref = _datasets(audio_dir, random_crop=True, augment_phase=True)
    for seed in range(4):
        for i in range(len(port)):
            j = ref.filenames.index(port.filenames[i])
            random.seed(seed)
            got = port[i]
            random.seed(seed)
            _assert_items_equal(got, ref[j])


def test_resample_matches_jax():
    # the port resamples with scipy's polyphase filter; the JAX package with
    # its native kernel when built (else the same scipy call). Both are
    # Kaiser-windowed sinc filters of the same length: 1e-3 on unit noise
    x = np.random.default_rng(2).standard_normal(4800).astype(np.float32)
    got = tresample.resample_poly_np(x, 48000, 44100)
    want = jresample.resample_poly_np(x, 48000, 44100)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[50:-50], want[50:-50], atol=1e-3)


def test_loudness_and_volume_norm_match_jax():
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal((2, SR))).astype(np.float32)
    np.testing.assert_allclose(tutils.measure_loudness_lufs(x, SR),
                               jutils.measure_loudness_lufs(x, SR), atol=1e-6)
    random.seed(5)
    got = tutils.VolumeNorm((-16, 2), SR)(x)
    assert np.isclose(tutils.measure_loudness_lufs(got, SR), -16, atol=2.01)


@pytest.mark.parametrize("num_workers", [0, 1])
def test_dataloader_batches(audio_dir, num_workers):
    # collation: audio stacked into one float32 tensor [B, 2, T], metadata a
    # list of dicts; a spawned worker rebuilds the custom metadata function
    # from its module path
    root, module = audio_dir
    config = {"dataset_type": "audio_dir", "random_crop": False, "augment_phase": False,
              "datasets": [{"id": "a", "path": root, "custom_metadata_module": module}]}
    loader = tds.create_dataloader_from_config(config, batch_size=2, sample_size=SAMPLE_SIZE,
                                               sample_rate=SR, num_workers=num_workers)
    batches = list(loader)
    assert len(batches) == 2
    for audio, meta in batches:
        assert isinstance(audio, torch.Tensor) and audio.dtype == torch.float32
        assert tuple(audio.shape) == (2, 2, SAMPLE_SIZE) and len(meta) == 2
        assert all(m["prompt"].startswith("clip ") for m in meta)
    with pytest.raises(NotImplementedError):  # tar shards: a later slice
        tds.create_dataloader_from_config(dict(config, dataset_type="wds"), 2,
                                          SAMPLE_SIZE, SR)

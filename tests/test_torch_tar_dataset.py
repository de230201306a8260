"""Local tar shards (`dataset_type: "tar"`, the shipped tar_wds_example.json's
type) through the port's loader against the JAX package's LocalTarDataset
(data/dataset.py:293) on shards written here with `tarfile` from seeded
synthetic WAVs: the same samples in the same order with the same audio and
metadata when the crop is not random, a corrupt member skipped as JAX skips
it, resampling, and each loader worker reading a disjoint share of the
shards.
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from stable_audio_tools_tpu.data import dataset as jdata
from stable_audio_tools_tpu_torch.data import dataset as tdata
from stable_audio_tools_tpu_torch.data.wav import save_wav

SR = 16000


def _wav_bytes(audio: np.ndarray, sr: int = SR) -> bytes:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.wav")
        save_wav(path, audio, sr)
        with open(path, "rb") as f:
            return f.read()


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_shards(root: str, n_shards: int = 3, per_shard: int = 3, corrupt: bool = True,
                 sr: int = SR) -> list:
    """Shards of `per_shard` samples each (stereo WAV + JSON metadata, some
    with a `text` only, one `__reject__`ed), the second shard's second WAV
    truncated to a header when `corrupt`."""
    rng = np.random.default_rng(0)
    paths = []
    for s in range(n_shards):
        path = os.path.join(root, f"shard-{s:03d}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(per_shard):
                key = f"sample{s}_{i}"
                n = 1200 + 500 * i + 100 * s
                audio = (0.4 * rng.standard_normal((2, n))).astype(np.float32)
                data = _wav_bytes(audio, sr)
                if corrupt and (s, i) == (1, 1):
                    data = data[:30]
                meta = {"text": f"clip {s} {i}"} if i % 2 else {"prompt": f"p{s}{i}", "bpm": 120}
                if (s, i) == (2, 2):
                    meta["__reject__"] = True
                _add(tf, f"{key}.wav", data)
                _add(tf, f"{key}.json", json.dumps(meta).encode())
        paths.append(path)
    return paths


def _config(root: str) -> dict:
    return {"dataset_type": "tar", "random_crop": False, "augment_phase": False,
            "datasets": [{"id": "shards", "path": root}]}


def _jax_samples(root, sample_rate=SR, channels=2):
    shards = sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".tar"))
    ds = jdata.LocalTarDataset(shards, sample_size=2048, sample_rate=sample_rate,
                               force_channels="stereo" if channels == 2 else "mono",
                               random_crop=False, augment_phase=False, shuffle=False)
    return list(ds)


def _port_samples(root, sample_rate=SR, channels=2, **kw):
    loader = tdata.create_dataloader_from_config(
        _config(root), batch_size=1, sample_size=2048, sample_rate=sample_rate,
        audio_channels=channels, num_workers=0, shuffle=False, **kw)
    return [(a[0].numpy(), m[0]) for a, m in loader]


def _same(got, want, atol=0.0):
    assert len(got) == len(want)
    for (ga, gm), (wa, wm) in zip(got, want):
        np.testing.assert_allclose(ga, wa, rtol=0, atol=atol)
        assert sorted(gm) == sorted(wm)
        for k in wm:
            np.testing.assert_array_equal(np.asarray(gm[k]), np.asarray(wm[k]), err_msg=k)


def test_tar_samples_match_jax(tmp_path, capsys):
    # 9 samples, one corrupt (skipped and printed by both), one rejected: 7
    write_shards(str(tmp_path))
    want = _jax_samples(str(tmp_path))
    jax_out = capsys.readouterr().out
    got = _port_samples(str(tmp_path))
    port_out = capsys.readouterr().out
    assert len(want) == 7
    _same(got, want)
    assert [m.get("prompt") for _, m in got][:4] == ["p00", "clip 0 1", "p02", "p10"]
    assert jax_out.count("Skipping corrupt sample") == port_out.count(
        "Skipping corrupt sample") == 1
    assert all(a.shape == (2, 2048) and a.dtype == np.float32 for a, _ in got)


def test_tar_resamples_to_the_model_rate(tmp_path):
    # 16 kHz shards read for a 24 kHz model: both resample each clip, the
    # port by scipy's polyphase filter in f64, the JAX package by its native
    # f32 one where built: within 1e-6 (f32 roundings of samples below 1.5)
    write_shards(str(tmp_path), n_shards=1, corrupt=False)
    _same(_port_samples(str(tmp_path), sample_rate=24000),
          _jax_samples(str(tmp_path), sample_rate=24000), atol=1e-6)


def test_each_worker_reads_its_own_shards(tmp_path):
    # two spawn workers over 3 shards: every sample once, none twice (each
    # batch comes whole from one worker's shards)
    write_shards(str(tmp_path), corrupt=False)
    loader = tdata.create_dataloader_from_config(
        _config(str(tmp_path)), batch_size=1, sample_size=2048, sample_rate=SR,
        num_workers=2, shuffle=False)
    prompts = sorted(m[0]["prompt"] for _, m in loader)
    want = sorted(m["prompt"] for _, m in _jax_samples(str(tmp_path)))
    assert prompts == want and len(prompts) == 8
    ds = loader.dataset
    assert ds.shards == sorted(ds.shards) and len(ds.shards) == 3


def test_ranks_and_resampling_stream(tmp_path):
    # rank 1 of 2 takes the sorted shards [1::2]; `resample_shards` cycles
    write_shards(str(tmp_path), corrupt=False)
    cfg = dict(_config(str(tmp_path)), resample_shards=True)
    loader = tdata.create_dataloader_from_config(cfg, batch_size=2, sample_size=2048,
                                                 sample_rate=SR, num_workers=0, shuffle=False,
                                                 rank=1, world_size=2)
    assert [os.path.basename(p) for p in loader.dataset.shards] == ["shard-001.tar"]
    it = iter(loader)
    prompts = [m["prompt"] for _ in range(4) for m in next(it)[1]]
    assert prompts == ["p10", "clip 1 1", "p12"] * 2 + ["p10", "clip 1 1"]


def test_s3_paths_are_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="s3"):
        tdata.create_dataloader_from_config(
            {"dataset_type": "tar", "datasets": [{"id": "x", "path": "s3://bucket/shards"}]},
            batch_size=1, sample_size=16, sample_rate=SR, num_workers=0)


def test_shipped_tar_config_builds_with_local_shards(tmp_path):
    # the shipped example with its path pointed at local shards
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "stable_audio_tools_tpu", "configs", "dataset_configs",
                           "tar_wds_example.json")) as f:
        cfg = json.load(f)
    write_shards(str(tmp_path), n_shards=1, corrupt=False)
    cfg["datasets"][0]["path"] = str(tmp_path)
    loader = tdata.create_dataloader_from_config(cfg, batch_size=2, sample_size=1024,
                                                 sample_rate=SR, num_workers=0)
    audio, meta = next(iter(loader))
    assert audio.shape == (2, 2, 1024) and torch.isfinite(audio).all() and len(meta) == 2

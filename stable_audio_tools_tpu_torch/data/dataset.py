"""Audio datasets and the loader factory; counterpart of
stable_audio_tools_tpu/data/dataset.py (fast_scandir :40, is_silence :68,
SampleDataset :129, collation_fn :453, create_dataloader_from_config :540).

Host-side numpy, loaded through `torch.utils.data.DataLoader` (workers
started with `spawn`). The rank and world size are arguments, where the JAX
package asks `jax.process_index()`; with more than one process each rank
reads its own shard (`DistributedSampler`). Covered: `dataset_type:
"audio_dir"` and `"pre_encoded"` (PreEncodedDataset :224, the latents that
`python -m stable_audio_tools_tpu_torch.pre_encode` or the JAX package's
`pre_encode.py` writes); tar-shard datasets are a later slice.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import typing as tp

import numpy as np
import torch

from .resample import resample_poly_np
from .utils import Mono, PadCrop_Normalized_T, PhaseFlipper, Stereo, VolumeNorm
from .wav import AUDIO_EXTENSIONS, load_audio


def fast_scandir(path: str, exts: tp.Sequence[str]) -> tp.Tuple[list, list]:
    """Recursive scan: (subfolders, files with one of `exts`)."""
    subfolders, files = [], []
    try:
        for entry in os.scandir(path):
            try:
                if entry.is_dir(follow_symlinks=False):
                    subfolders.append(entry.path)
                elif entry.is_file() and os.path.splitext(entry.name)[1].lower() in exts:
                    files.append(entry.path)
            except OSError:
                continue
    except OSError:
        return subfolders, files
    for sub in list(subfolders):
        sf, f = fast_scandir(sub, exts)
        subfolders.extend(sf)
        files.extend(f)
    return subfolders, files


def is_silence(audio: np.ndarray, thresh: float = -60.0) -> bool:
    """True when the clip's peak is below `thresh` dBFS."""
    peak = float(np.max(np.abs(audio))) if np.asarray(audio).size else 0.0
    return 20.0 * np.log10(max(peak, 1e-12)) < thresh


def _load_custom_metadata_fn(module_path: str):
    spec = importlib.util.spec_from_file_location("custom_metadata", module_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_custom_metadata


class SampleDataset(torch.utils.data.Dataset):
    """Audio files under the configs' `path`s, cropped or padded to
    `sample_size` samples at `sample_rate`; items are (audio [C, T] float32,
    info dict). A file that fails to load, a silent crop, or one its custom
    metadata rejects is replaced by a random other item."""

    def __init__(self, configs: tp.Sequence[dict], sample_size: int = 65536,
                 sample_rate: int = 48000, force_channels: str = "stereo",
                 random_crop: bool = True, augment_phase: bool = True,
                 volume_norm: bool = False,
                 volume_norm_param: tp.Tuple[float, float] = (-16, 2)):
        self.sample_size = sample_size
        self.sample_rate = sample_rate
        self.pad_crop = PadCrop_Normalized_T(sample_size, sample_rate, randomize=random_crop)
        self.encoding = {"stereo": Stereo(), "mono": Mono()}.get(force_channels)
        self.augs = []
        if augment_phase:
            self.augs.append(PhaseFlipper())
        if volume_norm:
            self.augs.append(VolumeNorm(volume_norm_param, sample_rate))
        self.filenames = []
        # module paths, loaded on first use in the process that reads items
        # (workers start with spawn and receive this object pickled)
        self.custom_metadata_modules = {}
        self._custom_fns = None
        for config in configs:
            self.filenames.extend(fast_scandir(config["path"], AUDIO_EXTENSIONS)[1])
            if config.get("custom_metadata_module") is not None:
                self.custom_metadata_modules[config["path"]] = config["custom_metadata_module"]
        self.root_paths = [c["path"] for c in configs]

    def __len__(self) -> int:
        return len(self.filenames)

    def load_file(self, filename: str) -> np.ndarray:
        audio, sr = load_audio(filename)
        if sr != self.sample_rate:
            audio = np.stack([resample_poly_np(ch, sr, self.sample_rate) for ch in audio])
        return audio

    def _custom_metadata_fns(self) -> dict:
        if self._custom_fns is None:
            self._custom_fns = {root: _load_custom_metadata_fn(path)
                                for root, path in self.custom_metadata_modules.items()}
        return self._custom_fns

    def __getitem__(self, idx: int):
        filename = self.filenames[idx]
        try:
            audio = self.load_file(filename)
        except (OSError, ValueError) as e:
            print(f"Couldn't load file {filename}: {e}")
            return self[random.randrange(len(self))]
        audio, t_start, t_end, seconds_start, seconds_total, padding_mask = self.pad_crop(audio)
        if is_silence(audio):
            return self[random.randrange(len(self))]
        if self.encoding is not None:
            audio = self.encoding(audio)
        for aug in self.augs:
            audio = aug(audio)
        audio = np.clip(audio, -1.0, 1.0).astype(np.float32)
        root = next((r for r in self.root_paths if filename.startswith(r)),
                    os.path.dirname(filename))
        info = {"path": filename, "relpath": os.path.relpath(filename, root),
                "timestamps": (t_start, t_end), "seconds_start": seconds_start,
                "seconds_total": seconds_total, "padding_mask": padding_mask}
        for root, fn in self._custom_metadata_fns().items():
            if filename.startswith(root):
                custom = fn(info, audio)
                if custom.get("__reject__"):
                    return self[random.randrange(len(self))]
                if "__audio__" in custom:
                    audio = custom.pop("__audio__")
                info.update(custom)
        return audio, info


class PreEncodedDataset(torch.utils.data.Dataset):
    """Latents [C, T] (`.npy`, f32; [1, C, T] is squeezed) under the configs'
    `path`s: the files `filelist.txt` there lists, else every `.npy` found,
    each with its metadata in a `.json` of the same name where there is one.
    Items are (latents [C, latent_crop_length] f32, info dict), where
    `latent_crop_length` defaults to `sample_size` (JAX :224-291):
    - longer latents are cropped: at a random start that keeps the crop
      inside the valid (padding-mask) region where it can (`random_crop`),
      else from 0; shorter ones are zero-padded at the end;
    - `info["padding_mask"]` is the item's mask (all ones without one) cut
      or padded with the latents, f32;
    - `seconds_start` and `seconds_total` default to 0, and a `__replace__`
      dict in the metadata replaces the keys it names.
    A file that fails to load is replaced by a random other item."""

    def __init__(self, configs: tp.Sequence[dict], sample_size: int = 1024,
                 random_crop: bool = True, latent_crop_length: tp.Optional[int] = None):
        self.latent_crop_length = latent_crop_length or sample_size
        self.random_crop = random_crop
        self.filenames = []
        for config in configs:
            path = config["path"]
            filelist = os.path.join(path, "filelist.txt")
            if os.path.exists(filelist):
                with open(filelist) as f:
                    self.filenames.extend(os.path.join(path, line.strip())
                                          for line in f if line.strip())
            else:
                self.filenames.extend(fast_scandir(path, [".npy"])[1])

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, idx: int):
        fn = self.filenames[idx]
        try:
            latents = np.load(fn).astype(np.float32)
            meta_path = os.path.splitext(fn)[0] + ".json"
            info = {}
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    info = json.load(f)
        except (OSError, ValueError) as e:
            print(f"Couldn't load latents {fn}: {e}")
            return self[random.randrange(len(self))]
        if latents.ndim == 3:
            latents = latents[0]
        padding_mask = np.asarray(info.get("padding_mask", np.ones(latents.shape[-1])),
                                  np.float32)
        L, T = self.latent_crop_length, latents.shape[-1]
        if T > L:
            start = 0
            if self.random_crop:
                hi = max(min(int(padding_mask.sum()), T) - L, 0)
                start = random.randint(0, hi) if hi > 0 else 0
            latents = latents[:, start:start + L]
            padding_mask = padding_mask[start:start + L]
        elif T < L:
            latents = np.pad(latents, ((0, 0), (0, L - T)))
            padding_mask = np.pad(padding_mask, (0, L - T))
        info["padding_mask"] = padding_mask.astype(np.float32)
        info.setdefault("seconds_start", 0)
        info.setdefault("seconds_total", 0)
        if "__replace__" in info:
            info.update(info.pop("__replace__"))
        return latents, info


def collation_fn(samples: tp.Sequence[tp.Tuple[np.ndarray, dict]]):
    """Stack the audio into one tensor [B, C, T]; metadata stays a list."""
    return torch.from_numpy(np.stack([s[0] for s in samples])), [s[1] for s in samples]


def create_dataloader_from_config(dataset_config: dict, batch_size: int, sample_size: int,
                                  sample_rate: int, audio_channels: int = 2,
                                  num_workers: int = 4, shuffle: bool = True, rank: int = 0,
                                  world_size: int = 1, seed: int = 0
                                  ) -> torch.utils.data.DataLoader:
    """A DataLoader of (audio [B, C, sample_size], metadata list) batches,
    or, for `pre_encoded`, (latents [B, C, latent_crop_length], metadata
    list); incomplete last batches are dropped."""
    dataset_type = dataset_config.get("dataset_type")
    if dataset_type is None:
        raise ValueError("dataset_type must be specified in dataset config")
    random_crop = dataset_config.get("random_crop", True)
    if dataset_type == "audio_dir":
        force_channels = ("stereo" if audio_channels == 2 else
                          "mono" if audio_channels == 1 else "foa")
        dataset = SampleDataset(
            dataset_config.get("datasets", []), sample_size=sample_size,
            sample_rate=sample_rate, force_channels=force_channels, random_crop=random_crop,
            augment_phase=dataset_config.get("augment_phase", True),
            volume_norm=dataset_config.get("volume_norm", False),
            volume_norm_param=tuple(dataset_config.get("volume_norm_param", (-16, 2))))
    elif dataset_type == "pre_encoded":
        dataset = PreEncodedDataset(
            dataset_config.get("datasets", []), sample_size=sample_size, random_crop=random_crop,
            latent_crop_length=dataset_config.get("latent_crop_length"))
    else:
        raise NotImplementedError(f"dataset type {dataset_type} is not ported yet")
    if len(dataset) == 0:
        raise ValueError(f"no {dataset_type} files under "
                         f"{[d['path'] for d in dataset_config['datasets']]}")
    sampler = None
    if world_size > 1:
        sampler = torch.utils.data.distributed.DistributedSampler(
            dataset, num_replicas=world_size, rank=rank, shuffle=shuffle, seed=seed)
    generator = torch.Generator().manual_seed(seed)
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size, shuffle=shuffle and sampler is None, sampler=sampler,
        num_workers=num_workers, collate_fn=collation_fn, drop_last=True,
        generator=generator, persistent_workers=num_workers > 0,
        multiprocessing_context="spawn" if num_workers > 0 else None)

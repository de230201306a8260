"""Demo callbacks: audio rendered during training; counterpart of
stable_audio_tools_tpu/training/demos.py (`create_demo_callback_from_config`
:18, `_DemoBase._save` :53, `DiffusionCondDemoCallback` :111,
`DiffusionCondInpaintDemoCallback` :153, `DiffusionUncondDemoCallback` :252,
`LMDemoCallback` :266, `DiffusionAutoencoderDemoCallback` :214,
`AutoencoderDemoCallback` :298 with `_disc_sensitivity_probe` :341).

A callback is called as `callback(wrapper, step)` by the trainer (rank 0,
every `demo_every` steps). It renders with the EMA weights where the trainer
keeps them (`ema_weights`; the training weights come back bit for bit), in
eval mode, drawing its random numbers from a generator of its own seeded
with `step` (the JAX demos' `seed=step`), never the training's. The
conditioned demo goes through `generate_diffusion_cond` and the
pretransform's decode, the path a user's request takes.

`_save` writes each item as `{name}_step{step}_{b}.wav`, scaled by 0.95 over
the batch's peak, logs the first item and the file list, and, where
matplotlib is installed, the mel spectrogram (and the latents' heat map and
PCA) as PNGs; without matplotlib it writes the audio only. `outputs` holds
the last call's audio (before the peak scaling) by name. The autoencoder
demo's `compute_fad` is refused by name.
"""

from __future__ import annotations

import contextlib
import os
import typing as tp

import numpy as np
import torch

from .ema import ema_weights

def create_demo_callback_from_config(model_config: dict, demo_dir: str = "demos", demo_dl=None,
                                     logger=None):
    """The demo callback of the config's model type, configured by its
    `training.demo` section; `demo_dl` gives the autoencoder, diffusion
    autoencoder and inpainting demos their reals."""
    model_type = model_config["model_type"]
    demo_config = model_config.get("training", {}).get("demo", {})
    if model_type == "diffusion_autoencoder":
        return DiffusionAutoencoderDemoCallback(model_config, demo_dir, demo_config, demo_dl,
                                                logger)
    if model_type == "diffusion_cond_inpaint":
        return DiffusionCondInpaintDemoCallback(model_config, demo_dir, demo_config, demo_dl,
                                                logger)
    if model_type == "diffusion_cond":
        return DiffusionCondDemoCallback(model_config, demo_dir, demo_config, logger)
    if model_type == "diffusion_uncond":
        return DiffusionUncondDemoCallback(model_config, demo_dir, demo_config, logger)
    if model_type == "autoencoder":
        return AutoencoderDemoCallback(model_config, demo_dir, demo_config, demo_dl, logger)
    if model_type == "lm":
        return LMDemoCallback(model_config, demo_dir, demo_config, logger)
    return None


class _DemoBase:
    def __init__(self, model_config: dict, demo_dir: str, demo_config: dict, logger=None):
        self.model_config = model_config
        self.demo_dir = demo_dir
        self.demo_config = demo_config
        self.logger = logger
        self.sample_rate = model_config["sample_rate"]
        self.sample_size = demo_config.get("demo_sample_size", model_config["sample_size"])
        self.outputs: tp.Dict[str, np.ndarray] = {}

    @staticmethod
    def _generator(wrapper, step: int) -> torch.Generator:
        return torch.Generator(device=wrapper.device).manual_seed(step)

    def _save(self, audio: np.ndarray, name: str, step: int,
              latents: tp.Optional[np.ndarray] = None, caption: tp.Optional[str] = None
              ) -> tp.List[str]:
        """Write `audio` [B, C, T] as wavs (and pictures), log it; returns the
        wav paths."""
        from ..data.wav import save_wav

        os.makedirs(self.demo_dir, exist_ok=True)
        audio = np.asarray(audio, np.float32)
        self.outputs[name] = audio
        peak = np.abs(audio).max() or 1.0
        paths = []
        for b in range(audio.shape[0]):
            path = os.path.join(self.demo_dir, f"{name}_step{step}_{b}.wav")
            save_wav(path, audio[b] / peak * 0.95, self.sample_rate)
            paths.append(path)
        if self.logger is not None:
            self.logger.log_audio(f"demo/{name}", audio[0] / peak * 0.95, self.sample_rate,
                                  caption=caption or name, step=step)
            self.logger.log_metrics({f"demo/{name}_files": paths}, step=step)
        from ..interface.aeiou import (audio_spectrogram_image, pca_point_cloud, pyplot,
                                       tokens_spectrogram_image)

        try:
            plt = pyplot()
        except ImportError:
            return paths

        images = {"melspec": (f"{name}_step{step}_mel.png",
                              audio_spectrogram_image(audio[0], self.sample_rate))}
        if latents is not None:
            images["latents_melspec"] = (f"{name}_step{step}_latents.png",
                                         tokens_spectrogram_image(latents))
            images["latents_pca"] = (f"{name}_step{step}_latents_pca.png",
                                     pca_point_cloud(latents))
        for key, (file, img) in images.items():
            plt.imsave(os.path.join(self.demo_dir, file), img)
            if self.logger is not None:
                self.logger.log_image(f"demo/{name}_{key}", img, step=step)
        return paths


@contextlib.contextmanager
def _eval_mode(model: torch.nn.Module):
    """The model in eval mode for the block, its mode restored after."""
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


class DiffusionCondDemoCallback(_DemoBase):
    """One request per `demo_cfg_scales` entry for the `demo_cond` prompts,
    `demo_steps` sampler steps, decoded by the pretransform."""

    def __call__(self, wrapper, step: int) -> None:
        from ..inference.generation import generate_diffusion_cond

        model = wrapper.model
        prompts = self.demo_config.get("demo_cond", [
            {"prompt": "demo", "seconds_start": 0, "seconds_total": 10}])
        steps = self.demo_config.get("demo_steps", 50)
        caption = "; ".join(str(p.get("prompt", p)) for p in prompts)
        with ema_weights(wrapper.params, wrapper.ema), _eval_mode(model):
            for scale in self.demo_config.get("demo_cfg_scales", [6.0]):
                latents = generate_diffusion_cond(
                    model, steps=steps, cfg_scale=scale, conditioning=list(prompts),
                    batch_size=len(prompts), sample_size=self.sample_size, seed=step,
                    return_latents=True)
                if model.pretransform is not None:
                    with torch.inference_mode():
                        audio = model.pretransform.decode(
                            latents, generator=self._generator(wrapper, step))
                else:
                    audio, latents = latents, None
                self._save(audio.float().cpu().numpy(), f"demo_cfg{scale}", step,
                           latents=None if latents is None else latents.float().cpu().numpy(),
                           caption=f"cfg={scale} | {caption}")


class DiffusionCondInpaintDemoCallback(_DemoBase):
    """`num_demos` reals from `demo_dl` (cut to the demo's sample size), the
    same reals masked by `demo_mask_args` (default: the middle half with
    soft edges) for display, and one inpainting request per
    `demo_cfg_scales` entry that regenerates the masked region, conditioned
    on the reals' metadata: `inpaint_reals`, `inpaint_masked_input` and
    `inpaint_cfg{scale}`."""

    def __init__(self, model_config, demo_dir, demo_config, demo_dl, logger=None):
        super().__init__(model_config, demo_dir, demo_config, logger)
        self.demo_dl = demo_dl

    def __call__(self, wrapper, step: int) -> None:
        from ..inference.generation import build_mask, generate_diffusion_cond_inpaint

        if self.demo_dl is None:
            return
        num_demos = self.demo_config.get("num_demos", 2)
        audio, metadata = next(iter(self.demo_dl))
        audio = np.asarray(audio, np.float32)[:num_demos]
        metadata = list(metadata)[:num_demos]
        T = min(audio.shape[-1], self.sample_size)
        audio = audio[..., :T]
        self._save(audio, "inpaint_reals", step)
        mask_args = self.demo_config.get("demo_mask_args", {
            "maskstart": T // 4, "maskend": 3 * T // 4, "softnessL": 0.05, "softnessR": 0.05})
        self._save(audio * build_mask(T, mask_args).numpy()[None, None, :],
                   "inpaint_masked_input", step)
        model = wrapper.model
        with ema_weights(wrapper.params, wrapper.ema), _eval_mode(model):
            for scale in self.demo_config.get("demo_cfg_scales", [6.0]):
                out = generate_diffusion_cond_inpaint(
                    model, steps=self.demo_config.get("demo_steps", 50), cfg_scale=scale,
                    conditioning=metadata if model.conditioner is not None else None,
                    batch_size=audio.shape[0], sample_size=T, seed=step,
                    init_audio=(self.sample_rate, audio), mask_args=mask_args)
                self._save(out.float().cpu().numpy(), f"inpaint_cfg{scale}", step,
                           caption=f"inpaint cfg={scale}")


class DiffusionUncondDemoCallback(_DemoBase):
    """`num_demos` unconditional clips of `demo_steps` sampler steps."""

    def __call__(self, wrapper, step: int) -> None:
        from ..inference.generation import generate_diffusion_uncond

        with ema_weights(wrapper.params, wrapper.ema), _eval_mode(wrapper.model):
            audio = generate_diffusion_uncond(
                wrapper.model, steps=self.demo_config.get("demo_steps", 50),
                batch_size=self.demo_config.get("num_demos", 2), sample_size=self.sample_size,
                seed=step)
        self._save(audio.float().cpu().numpy(), "demo", step)


class DiffusionAutoencoderDemoCallback(_DemoBase):
    """`num_demos` (default 2) reals from `demo_dl` encoded and decoded in
    `demo_steps` (default 50) with the EMA weights (JAX :214): `diffae_reals`
    and `diffae_recon` (with the latents)."""

    def __init__(self, model_config, demo_dir, demo_config, demo_dl, logger=None):
        super().__init__(model_config, demo_dir, demo_config, logger)
        self.demo_dl = demo_dl

    def __call__(self, wrapper, step: int) -> None:
        if self.demo_dl is None:
            return
        audio = np.asarray(next(iter(self.demo_dl))[0],
                           np.float32)[:self.demo_config.get("num_demos", 2)]
        model, g = wrapper.model, self._generator(wrapper, step)
        with torch.no_grad(), ema_weights(wrapper.params, wrapper.ema), _eval_mode(model):
            latents = model.encode(torch.from_numpy(audio).to(wrapper.device), generator=g)
            recon = model.decode(latents, self.demo_config.get("demo_steps", 50), generator=g)
        self._save(audio, "diffae_reals", step)
        self._save(recon.float().cpu().numpy(), "diffae_recon", step,
                   latents=latents.float().cpu().numpy())


class LMDemoCallback(_DemoBase):
    """One clip for the `demo_cond` prompts (KV-cached), `demo_max_gen_len`
    frames (default: the sample size's), `demo_cfg_scale`."""

    @torch.no_grad()
    def __call__(self, wrapper, step: int) -> None:
        from ..models.lm import lm_generate_audio

        model = wrapper.model
        max_gen_len = self.demo_config.get("demo_max_gen_len",
                                           self.sample_size // model.min_input_length)
        with ema_weights(wrapper.params, wrapper.ema), _eval_mode(model):
            cond = None
            if model.conditioner is not None:
                cond = model.conditioner(self.demo_config.get("demo_cond", [{"prompt": "demo"}]),
                                         wrapper.device)
            audio = lm_generate_audio(model, cond, max_gen_len=max_gen_len,
                                      cfg_scale=self.demo_config.get("demo_cfg_scale"),
                                      generator=self._generator(wrapper, step))
        self._save(audio.float().cpu().numpy(), "lm_demo", step)


class AutoencoderDemoCallback(_DemoBase):
    """A batch of `demo_dl`'s reals through the trainer's forward (encode,
    decode) with the EMA weights, the reconstructions and the reals saved,
    then the discriminator's sensitivity (`_disc_sensitivity_probe`)."""

    def __init__(self, model_config, demo_dir, demo_config, demo_dl, logger=None):
        super().__init__(model_config, demo_dir, demo_config, logger)
        if demo_config.get("compute_fad"):
            raise NotImplementedError("compute_fad: FAD is not ported yet (ROADMAP queue 1 "
                                      "item 4)")
        self.demo_dl = demo_dl

    def __call__(self, wrapper, step: int) -> None:
        if self.demo_dl is None:
            return
        audio = next(iter(self.demo_dl))[0]
        reals = torch.as_tensor(audio).to(wrapper.device)
        with torch.no_grad(), ema_weights(wrapper.params, wrapper.ema), \
                _eval_mode(wrapper.model):
            recon, info = wrapper.ae_forward(reals, generator=self._generator(wrapper, step))
        self._save(recon.cpu().numpy(), "recon", step,
                   latents=info["latents"].float().cpu().numpy())
        self._save(np.asarray(audio, np.float32), "real", step)
        self._disc_sensitivity_probe(wrapper, info["reals"], recon, step)

    def _disc_sensitivity_probe(self, wrapper, reals: torch.Tensor, fakes: torch.Tensor,
                                step: int) -> None:
        """|d(adversarial + feature-matching loss) / d(fakes)|: where in time
        and frequency the discriminator pushes the generator now (JAX :341),
        through autograd; the discriminator's own gradients stay untouched.
        Kept in `outputs["disc_sensitivity"]`, drawn as a spectrogram where
        matplotlib is installed."""
        disc = getattr(wrapper, "discriminator", None)
        if disc is None:
            return
        fakes = fakes.detach().requires_grad_(True)
        with torch.enable_grad():
            _, adv, fm = disc.loss(reals, fakes)
            (g,) = torch.autograd.grad(adv + fm, fakes)
        g = g.abs().float().cpu().numpy()
        self.outputs["disc_sensitivity"] = g
        from ..interface.aeiou import audio_spectrogram_image, pyplot

        try:
            plt = pyplot()
        except ImportError:
            return

        img = audio_spectrogram_image(g[0], self.sample_rate)
        plt.imsave(os.path.join(self.demo_dir, f"disc_sensitivity_step{step}.png"), img)
        if self.logger is not None:
            self.logger.log_image("demo/disc_sensitivity", img, step=step)

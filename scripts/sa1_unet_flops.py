"""The FLOPs of one SA-1.0 UNet forward at CFG batch 2, counted from the
port's model: forward hooks on every conv, linear and attention module of
the shipped `txt2audio/stable_audio_1_0.json` UNet, run on the meta device
(shapes only; no memory, no card).

    python scripts/sa1_unet_flops.py

Counts 2 FLOPs a multiply-add: a conv's output samples x in x out x taps
(a transposed conv's input samples), a linear's rows x in x out, an
attention's two products 2 x (2 x B x H x N x M x D). Prints one JSON line
in TFLOP."""

import json
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from stable_audio_tools_tpu_torch.models import adp  # noqa: E402


def main():
    with open(os.path.join(ROOT, "stable_audio_tools_tpu", "configs", "model_configs",
                           "txt2audio", "stable_audio_1_0.json")) as f:
        cfg = json.load(f)
    # the fused LayerNorm has no meta mode: shapes only through F.layer_norm
    adp.BiasedLayerNorm.forward = lambda self, x: F.layer_norm(
        x, (x.shape[-1],), self.weight, self.bias, self.eps)
    with torch.device("meta"):
        wrapper = adp.create_adp_cond_wrapper("adp_cfg_1d", cfg["model"]["diffusion"]["config"])
    flops = {"conv": 0, "linear": 0, "attention": 0}

    def conv(m, args, out):
        samples = args[0].shape[2] if isinstance(m, torch.nn.ConvTranspose1d) else out.shape[2]
        flops["conv"] += (2 * out.shape[0] * samples * m.in_channels * m.out_channels
                          * m.kernel_size[0])

    def linear(m, args, out):
        flops["linear"] += 2 * args[0].numel() // args[0].shape[-1] * m.in_features * m.out_features

    def attention(m, args, kwargs, out):
        x, ctx = args[0], kwargs.get("context")
        B, N = x.shape[:2]
        M = N if ctx is None else ctx.shape[1]
        flops["attention"] += 2 * 2 * B * N * M * m.num_heads * m.head_features

    for mod in wrapper.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            mod.register_forward_hook(conv)
        elif isinstance(mod, torch.nn.Linear):
            mod.register_forward_hook(linear)
        elif isinstance(mod, adp.ADPAttention):
            mod.register_forward_hook(attention, with_kwargs=True)
    latents = cfg["sample_size"] // cfg["model"]["pretransform"]["config"]["downsampling_ratio"]
    x = torch.zeros(1, cfg["model"]["io_channels"], latents, device="meta")
    context = torch.zeros(1, 79, cfg["model"]["conditioning"]["cond_dim"], device="meta")
    wrapper(x, torch.zeros(1, device="meta"), cross_attn_cond=context, cfg_scale=6.0)
    out = {k: v / 1e12 for k, v in flops.items()}
    out["total"] = sum(out.values())
    print(json.dumps({"tflop_per_unet_forward_cfg_batch_2": out}))


if __name__ == "__main__":
    main()

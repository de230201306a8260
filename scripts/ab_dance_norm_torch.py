"""The DAU1d's GroupNorm two ways on one card, in turns (A, B, B, A):
`F.group_norm` in f32 (one thread block per item and group) and the port's
ops/norms.py `GroupNorm` (`torch.var_mean` over each item, then one
`addcmul`), inside BASELINE (b)'s model (dance_diffusion_base_16k.json, seeded random weights):
a sampler step at batch 1 x 65,536 and a training forward+backward at batch
4 x 65,536, each by CUDA events and under the profiler (device ms, kernels).

    python scripts/ab_dance_norm_torch.py      # on a machine with the card

Prints the card's line, then one JSON line a run.
"""

import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    from stable_audio_tools_tpu_torch.models.factory import create_model_from_config, init_random_
    from stable_audio_tools_tpu_torch.ops.kernels import _build
    from stable_audio_tools_tpu_torch.ops.norms import GroupNorm
    from stable_audio_tools_tpu_torch.training.factory import create_training_wrapper_from_config

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.card_line(), flush=True)
    _build.build_all()
    impls = {"group_norm": lambda self, x: F.group_norm(
                 x.float(), 1, self.weight, self.bias, self.eps).to(x.dtype),
             "var_mean": GroupNorm.forward}
    cfg = cs.dance_config()
    model = init_random_(create_model_from_config(cfg, dev),
                         torch.Generator(device=dev).manual_seed(0))
    w = create_training_wrapper_from_config(cfg, model)
    g = torch.Generator(device=dev).manual_seed(1)
    x1 = torch.randn(1, 2, cs.DANCE_SAMPLE_SIZE, generator=g, device=dev)
    t1 = torch.full((1,), 0.5, device=dev)
    audio = 0.3 * torch.randn(cs.DANCE_BATCH, 2, cs.DANCE_SAMPLE_SIZE, generator=g, device=dev)

    def step():
        with torch.inference_mode():
            model(x1, t1)

    def fwd_bwd():
        loss, _ = w.loss(audio, {}, counter=0)
        loss.backward()

    try:
        for name in ("group_norm", "var_mean", "var_mean", "group_norm"):
            GroupNorm.forward = impls[name]
            r = dict(impl=name, step_ms=cs.cuda_ms(step, 5), fwd_bwd_ms=cs.cuda_ms(fwd_bwd, 3))
            p, q = cs.profiled_window(step), cs.profiled_window(fwd_bwd)
            w.optimizer.zero_grad(set_to_none=True)
            r.update(step_device_ms=p["device_ms"], step_kernels=p["kernel_launches"],
                     fwd_bwd_device_ms=q["device_ms"], fwd_bwd_kernels=q["kernel_launches"])
            print(json.dumps(r), flush=True)
    finally:
        GroupNorm.forward = impls["var_mean"]


if __name__ == "__main__":
    main()

"""Evaluation metrics of the autoencoder validation step; counterpart of
stable_audio_tools_tpu/training/losses/metrics.py (`make_eval_metrics` :18).

`stft` (a three-resolution STFT distance), `sisdr` (negative SI-SDR) and
`mel` (a 128-band mel STFT distance), each a callable (decoded, reals) ->
scalar on the card. PESQ is refused by name (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import typing as tp

from .auraloss import MelSTFTLoss, MultiResolutionSTFTLoss, SISDRLoss


def make_eval_metrics(sample_rate: int, eval_loss_config: tp.Optional[dict] = None
                      ) -> tp.Dict[str, tp.Callable]:
    """{name: metric(decoded, reals)} for the names in `eval_loss_config`
    (default: stft, sisdr and mel)."""
    cfg = eval_loss_config or {"stft": {}, "sisdr": {}, "mel": {}}
    if "pesq" in cfg:
        raise NotImplementedError("the pesq metric is not ported yet (ROADMAP queue 1 item 4)")
    metrics = {}
    if "stft" in cfg:
        metrics["stft"] = MultiResolutionSTFTLoss(
            fft_sizes=(2048, 1024, 512), hop_sizes=(512, 256, 128),
            win_lengths=(2048, 1024, 512), sample_rate=sample_rate)
    if "sisdr" in cfg:
        metrics["sisdr"] = SISDRLoss()
    if "mel" in cfg:
        metrics["mel"] = MelSTFTLoss(sample_rate)
    return metrics

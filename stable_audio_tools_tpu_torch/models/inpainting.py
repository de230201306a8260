"""Random inpainting masks for training; counterpart of
stable_audio_tools_tpu/models/inpainting.py (`random_inpaint_mask` :22).

The same mask family as the JAX package's vectorised redesign of the
reference's per-item loop: per batch item one of RANDOM_SEGMENTS (up to
`max_mask_segments` segments of random length and position inside the real
region), FULL_MASK (everything inpainted) or CAUSAL_MASK (a random prefix kept,
the rest of the real region inpainted), honouring padding masks. Mask value 0
means "inpaint here".

The random integers come from a `torch.Generator`, or from `draws`, a dict of
precomputed integer tensors (tests replay the JAX package's draws through
it): `mask_type` [B] in {0, 1, 2}, `num_segments` [B] in [1,
max_mask_segments], and three raw draws in [0, 2^31 - 1) that are reduced
modulo the lengths they index: `seg_len` and `seg_start` [B,
max_mask_segments] (`seg_len` from 1) and `prefix` [B].
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

MASK_RANDOM_SEGMENTS = 0
MASK_FULL = 1
MASK_CAUSAL = 2
INT32_MAX = 2 ** 31 - 1


def random_inpaint_mask(sequence: torch.Tensor, generator: Optional[torch.Generator] = None,
                        padding_masks: Optional[torch.Tensor] = None,
                        max_mask_segments: int = 10,
                        mask_type_probabilities: Optional[Sequence[float]] = None,
                        draws: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sequence [B, C, T]; padding_masks [B, T] (1 = real data). Returns
    (masked sequence, inpaint mask [B, 1, T] in sequence's dtype)."""
    B, _, T = sequence.shape
    device = sequence.device
    K = max_mask_segments
    if draws is None:
        probs = torch.tensor(mask_type_probabilities or [0.1, 0.8, 0.1], dtype=torch.float32)
        gdev = generator.device if generator is not None else device
        randint = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=generator,
                                                      device=gdev)
        draws = {
            "mask_type": torch.multinomial(probs.to(gdev), B, replacement=True,
                                           generator=generator),
            "num_segments": randint(1, K + 1, (B,)),
            "seg_len": randint(1, INT32_MAX, (B, K)),
            "seg_start": randint(0, INT32_MAX, (B, K)),
            "prefix": randint(0, INT32_MAX, (B,)),
        }
    d = {k: v.to(device=device, dtype=torch.long) for k, v in draws.items()}
    if padding_masks is None:
        padding_masks = torch.ones((B, T), device=device)
    real_len = padding_masks.long().sum(dim=1)  # [B]
    pos = torch.arange(T, device=device)[None, :]

    # RANDOM_SEGMENTS: K candidates, the first num_segments of them active
    max_len = (real_len[:, None] // d["num_segments"][:, None].clamp(min=1)).clamp(min=1)
    seg_len = d["seg_len"] % max_len + 1
    seg_start = d["seg_start"] % ((real_len[:, None] - seg_len).clamp(min=0) + 1)
    active = torch.arange(K, device=device)[None, :] < d["num_segments"][:, None]
    in_seg = ((pos[:, None, :] >= seg_start[:, :, None])
              & (pos[:, None, :] < (seg_start + seg_len)[:, :, None]) & active[:, :, None])
    segments_mask = 1.0 - in_seg.any(dim=1).float()

    # CAUSAL: keep a random prefix of the real region, inpaint the rest of it
    prefix = d["prefix"] % (real_len + 1)
    causal_mask = torch.where((pos >= prefix[:, None]) & (pos < real_len[:, None]), 0.0, 1.0)

    # an empty real region leaves nothing to inpaint
    empty = (real_len == 0)[:, None]
    segments_mask = torch.where(empty, torch.ones_like(segments_mask), segments_mask)
    causal_mask = torch.where(empty, torch.ones_like(causal_mask), causal_mask)

    mask_type = d["mask_type"][:, None]
    mask = torch.where(mask_type == MASK_FULL, torch.zeros_like(causal_mask),
                       torch.where(mask_type == MASK_CAUSAL, causal_mask, segments_mask))
    mask = mask[:, None, :].to(sequence.dtype)
    return sequence * mask, mask

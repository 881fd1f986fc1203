"""Greedy CTC decoding.

Port of ``keras_ocr_tpu/ops/ctc.py:ctc_greedy_decode`` and
``ctc_decode_to_strings``: argmax per frame, collapse repeats, drop blanks
(the LAST class), left-pack, pad with -1.
"""

from __future__ import annotations

import numpy as np
import torch


def ctc_greedy_decode(probs):
    """(B, T, C) probabilities or logits -> (B, T) int32 labels, left-packed
    and padded with -1."""
    batch, time, num_classes = probs.shape
    blank = num_classes - 1
    preds = torch.argmax(probs, dim=-1).to(torch.int32)
    prev = torch.cat(
        [torch.full_like(preds[:, :1], blank), preds[:, :-1]], dim=1
    )
    keep = (preds != prev) & (preds != blank)
    # Kept frames go to their rank; the rest to a spill column, cut off.
    spill = torch.full_like(preds, time, dtype=torch.int64)
    slot = torch.where(keep, torch.cumsum(keep, 1) - 1, spill)
    out = torch.full((batch, time + 1), -1, dtype=torch.int32, device=probs.device)
    out.scatter_(1, slot, torch.where(keep, preds, -1))
    return out[:, :time]


def ctc_decode_to_strings(decoded, alphabet: str) -> list:
    """-1-padded label rows -> python strings."""
    decoded = np.asarray(decoded)
    blank = len(alphabet)
    return [
        "".join(alphabet[idx] for idx in row if idx not in (blank, -1))
        for row in decoded
    ]

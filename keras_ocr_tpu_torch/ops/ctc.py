"""CTC loss and greedy decoding.

Port of ``keras_ocr_tpu/ops/ctc.py``. The blank is the LAST class and
labels are padded with -1.

``ctc_loss`` is the log-space alpha (forward) recursion over the
blank-interleaved label sequence, vectorised over batch and states, one
step per frame; its gradient comes from autograd. Impossible states hold
-1e30, not -inf: autograd's ``logsumexp`` of all -inf gives NaN gradients.
An infeasible alignment (repeats that need more frames than there are)
then costs about 1e30, as in the JAX package. ``torch.nn.functional
.ctc_loss`` is not used: it returns inf there, and its CUDA backward
accumulates with atomics.
"""

from __future__ import annotations

import numpy as np
import torch

_NEG_INF = -1e30


def _logsumexp(x, dim=0):
    """``jax.nn.logsumexp``: the shift by the maximum carries no gradient,
    so a group of equal -1e30 entries splits its gradient evenly (torch's
    ``logsumexp`` gives each the whole of it once log(3) is lost in the
    rounding of 1e30)."""
    shift = x.amax(dim, keepdim=True).detach()
    return torch.log(torch.exp(x - shift).sum(dim)) + shift.squeeze(dim)


def _shift_states(alpha, by):
    """alpha[:, s - by] at state s, -1e30 where s < by."""
    pad = torch.full_like(alpha[:, :by], _NEG_INF)
    return torch.cat([pad, alpha[:, :-by]], dim=1)


def ctc_loss(logits, labels, input_lengths, label_lengths, logits_are_log_probs=False):
    """Per-sample CTC negative log-likelihood.

    Args:
        logits: (B, T, C) unnormalised scores, or log-probabilities with
            ``logits_are_log_probs``. Class ``C - 1`` is the blank.
        labels: (B, L) int labels, padded with any value (commonly -1).
        input_lengths: (B,) valid frames per sample; the alphas freeze
            past them.
        label_lengths: (B,) valid labels per sample.

    Returns:
        (B,) losses, float32 (float64 for float64 logits).
    """
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    batch, time, num_classes = logits.shape
    device = logits.device
    blank = num_classes - 1
    max_label = labels.shape[1]
    num_states = 2 * max_label + 1
    log_probs = logits if logits_are_log_probs else torch.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(labels, device=device).to(torch.int64)
    label_lengths = torch.as_tensor(label_lengths, device=device).to(torch.int64).reshape(-1)
    input_lengths = torch.as_tensor(input_lengths, device=device).to(torch.int64).reshape(-1)

    state = torch.arange(num_states, device=device)
    is_label = (state % 2) == 1
    label_pos = ((state - 1) // 2).clamp(0, max_label - 1)
    safe_labels = labels.clamp(0, num_classes - 1)
    # ext[b, s]: the class state s emits (the blank at even states).
    ext = torch.where(is_label[None, :], safe_labels[:, label_pos], blank)  # (B, S)
    live = state[None, :] < (2 * label_lengths[:, None] + 1)
    # The skip s-2 -> s: a label state whose class differs from s-2's.
    ext_minus2 = torch.cat([torch.full_like(ext[:, :2], blank), ext[:, :-2]], dim=1)
    allow_skip = is_label[None, :] & (ext != ext_minus2)
    # emit[b, t, s]: log-probability of state s's class at frame t.
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(batch, time, num_states))

    neg = torch.full((batch, num_states), _NEG_INF, dtype=logits.dtype, device=device)
    first = torch.where(label_lengths > 0, emit[:, 0, 1], _NEG_INF)
    alpha = torch.cat([emit[:, 0, :1], first[:, None], neg[:, 2:]], dim=1)
    alpha = torch.where(live, alpha, _NEG_INF)
    for t in range(1, time):
        prev2 = torch.where(allow_skip, _shift_states(alpha, 2), _NEG_INF)
        merged = _logsumexp(torch.stack([alpha, _shift_states(alpha, 1), prev2]))
        new = torch.where(live, merged + emit[:, t], _NEG_INF)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)

    final = 2 * label_lengths  # the last blank state
    last_blank = torch.gather(alpha, 1, final[:, None])[:, 0]
    last_label = torch.gather(alpha, 1, (final - 1).clamp(min=0)[:, None])[:, 0]
    last_label = torch.where(label_lengths > 0, last_label, _NEG_INF)
    return -_logsumexp(torch.stack([last_blank, last_label]))


def ctc_greedy_decode(probs, mask=None, pad_value: int = -1):
    """(B, T, C) probabilities or logits -> (B, T) int32 labels: argmax per
    frame, repeats collapsed, blanks dropped, left-packed and padded with
    ``pad_value`` (negative). Frames where the optional (B, T) bool
    ``mask`` is False are ignored."""
    if pad_value >= 0:
        raise ValueError(f"pad_value must be negative, below every label; got {pad_value}")
    batch, time, num_classes = probs.shape
    blank = num_classes - 1
    preds = torch.argmax(probs, dim=-1).to(torch.int32)
    prev = torch.cat([torch.full_like(preds[:, :1], blank), preds[:, :-1]], dim=1)
    keep = (preds != prev) & (preds != blank)
    if mask is not None:
        keep = keep & torch.as_tensor(mask, device=probs.device)
    # Kept frames go to their rank; the rest to a spill column, cut off.
    spill = torch.full_like(preds, time, dtype=torch.int64)
    slot = torch.where(keep, torch.cumsum(keep, 1) - 1, spill)
    out = torch.full((batch, time + 1), pad_value, dtype=torch.int32, device=probs.device)
    out.scatter_(1, slot, torch.where(keep, preds, pad_value))
    return out[:, :time]


def ctc_decode_to_strings(decoded, alphabet: str) -> list:
    """-1-padded label rows -> python strings."""
    decoded = np.asarray(decoded)
    blank = len(alphabet)
    return [
        "".join(alphabet[idx] for idx in row if idx not in (blank, -1))
        for row in decoded
    ]

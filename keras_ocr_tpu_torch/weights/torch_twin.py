"""A functional torch forward of the CRAFT graph over clovaai's names.

It is written apart from the port's :class:`..models.CRAFT` and reads a
``state_dict`` in the original clovaai naming (``basenet.slice1.0``,
``upconv1.conv.0``, ``conv_cls.8``, ...), so a ``craft_mlt_25k.pth``
loads into it as it is. It checks the weight conversions and the port's
model against an independent forward: conv, BatchNorm, pooling, the
dilated conv, bilinear resizing and the skip concatenations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.craft import VGG_BLOCKS


def variables_to_torch_state_dict(variables) -> dict:
    """A standard CRAFT variable tree -> a clovaai-named ``state_dict`` of
    tensors (the inverse of :func:`..craft_variables_from_torch_state_dict`)."""
    from .export import craft_variables_to_torch_state_dict

    return {
        key: torch.from_numpy(value.copy())
        for key, value in craft_variables_to_torch_state_dict(variables).items()
        if not key.endswith("num_batches_tracked")
    }


def torch_craft_forward(sd, x):
    """The CRAFT graph on a (B, 3, H, W) normalised input; returns the
    (B, 2, H/2, W/2) heatmaps, channels first."""

    def conv(h, name, dilation=1):
        w = sd[f"{name}.weight"]
        pad = dilation * (w.shape[2] - 1) // 2
        return F.conv2d(h, w, sd[f"{name}.bias"], padding=pad, dilation=dilation)

    def bn(h, name):
        return F.batch_norm(h, sd[f"{name}.running_mean"], sd[f"{name}.running_var"],
                            sd[f"{name}.weight"], sd[f"{name}.bias"], training=False, eps=1e-5)

    taps = {}
    h = x
    for slice_name, idx, _, pool in VGG_BLOCKS:
        last = (slice_name, idx) == ("slice4", 37)
        h = bn(conv(h, f"basenet.{slice_name}.{idx}"), f"basenet.{slice_name}.{idx + 1}")
        if not last:
            h = F.relu(h)
        if (slice_name, idx) == ("slice1", 10):
            taps["s1"] = h
        elif (slice_name, idx) == ("slice2", 17):
            taps["s2"] = h
        elif (slice_name, idx) == ("slice3", 27):
            taps["s3"] = h
        elif last:
            taps["s4"] = h
        if pool:
            h = F.max_pool2d(h, 2, 2)

    s5 = F.max_pool2d(taps["s4"], 3, stride=1, padding=1)
    s5 = conv(s5, "basenet.slice5.1", dilation=6)
    s5 = conv(s5, "basenet.slice5.2")

    def upconv(h, i):
        h = F.relu(bn(conv(h, f"upconv{i}.conv.0"), f"upconv{i}.conv.1"))
        return F.relu(bn(conv(h, f"upconv{i}.conv.3"), f"upconv{i}.conv.4"))

    y = upconv(torch.cat([s5, taps["s4"]], dim=1), 1)
    for i, skip in ((2, "s3"), (3, "s2"), (4, "s1")):
        y = F.interpolate(y, size=taps[skip].shape[2:], mode="bilinear", align_corners=False)
        y = upconv(torch.cat([y, taps[skip]], dim=1), i)

    for n in (0, 2, 4, 6):
        y = F.relu(conv(y, f"conv_cls.{n}"))
    return conv(y, "conv_cls.8")


class TorchCRAFT:
    """The twin with keras-ocr's build-then-load usage."""

    def __init__(self, state_dict=None):
        self.state_dict_ = dict(state_dict or {})

    def load_state_dict(self, state_dict):
        self.state_dict_ = dict(state_dict)
        return self

    def __call__(self, x):
        return torch_craft_forward(self.state_dict_, x)


def copy_state_dict(state_dict) -> dict:
    """Strip a leading ``module.`` (``DataParallel``) from every key."""
    return {
        (key[len("module."):] if key.startswith("module.") else key): value
        for key, value in state_dict.items()
    }


def build_torch_model(weights_path=None) -> TorchCRAFT:
    """The twin, with a clovaai ``.pth`` loaded if ``weights_path`` is given."""
    model = TorchCRAFT()
    if weights_path is not None:
        state = torch.load(weights_path, map_location="cpu", weights_only=True)
        model.load_state_dict(copy_state_dict(state))
    return model

"""Text recognition: the CRNN model facade of the port.

Counterpart of ``keras_ocr_tpu/recognition.py``: ``rgb_to_grayscale_host``
and ``Recognizer`` with ``recognize`` (one pre-cropped image) and
``recognize_from_boxes`` (word boxes of whole images, cropped on the host
by :func:`..tools.warpBox`), the CRNN and the greedy CTC decode on the
recognizer's device; ``compile`` (a :class:`..train.RecognizerTrainer`) and
``get_batch_generator`` for training. The published-weight loaders are not
ported yet.
"""

from __future__ import annotations

import itertools
import string
import typing

import numpy as np
import torch

from . import tools
from . import weights as weights_lib
from .detection import default_device
from .models import CRNN, init_parameters
from .models.crnn import DEFAULT_BUILD_PARAMS
from .ops import ctc as ctc_ops

DEFAULT_ALPHABET = string.digits + string.ascii_lowercase


def rgb_to_grayscale_host(image: np.ndarray) -> np.ndarray:
    """uint8 RGB -> uint8 grey in OpenCV's fixed point:
    ``(9798 R + 19235 G + 3735 B + 2**14) >> 15``."""
    rgb = image.astype(np.int64)
    gray = (9798 * rgb[..., 0] + 19235 * rgb[..., 1] + 3735 * rgb[..., 2] + (1 << 14)) >> 15
    return gray.astype("uint8")


class Recognizer:
    """CRNN text recognizer.

    Args:
        alphabet: the character set (default digits + lowercase).
        weights: name of published pretrained weights; not loadable yet,
            so only ``None`` (seeded random weights, or a variable tree
            passed to :meth:`load_variables`) is accepted.
        build_params: CRNN build parameters (default
            :data:`~keras_ocr_tpu_torch.models.crnn.DEFAULT_BUILD_PARAMS`).
        device: where the model runs (default: the first GPU; without
            one, pass ``device="cpu"`` or the constructor raises).
        seed: seed of the random initialisation.
    """

    def __init__(
        self,
        alphabet: typing.Optional[str] = None,
        weights: typing.Optional[str] = None,
        build_params: typing.Optional[dict] = None,
        *,
        device=None,
        seed: int = 0,
    ):
        if weights is not None:
            raise NotImplementedError(
                f"pretrained weights {weights!r} cannot be loaded yet; use "
                "weights=None and load_variables()"
            )
        self.alphabet = alphabet or DEFAULT_ALPHABET
        self.build_params = dict(build_params or DEFAULT_BUILD_PARAMS)
        params = self.build_params
        channels = 3 if params["color"] else 1
        self.input_shape = (params["height"], params["width"], channels)
        self.device = torch.device(device) if device is not None else default_device()
        model = CRNN(
            alphabet_size=len(self.alphabet),
            height=params["height"],
            width=params["width"],
            color=params["color"],
            filters=tuple(params["filters"]),
            rnn_units=tuple(params["rnn_units"]),
            dropout=params["dropout"],
            rnn_steps_to_discard=params["rnn_steps_to_discard"],
            pool_size=params["pool_size"],
            stn=params["stn"],
        )
        self.model = init_parameters(model, seed=seed).to(self.device).eval()

    def load_variables(self, variables: dict) -> "Recognizer":
        """Load a JAX-package CRNN variable tree (numpy leaves)."""
        self.model.load_state_dict(weights_lib.crnn_state_dict(variables))
        for lstm in (self.model.lstm_10, self.model.lstm_11):
            lstm.flatten_parameters()  # cuDNN's one weight buffer
        return self

    @torch.inference_mode()
    def _predict_strings(self, crops: np.ndarray, batch_size=None) -> typing.List[str]:
        """(N, H, W, C) float32 crops in [0, 1] -> decoded strings: one
        upload, the CRNN and the CTC decode on the device in chunks of
        ``batch_size`` crops (all at once by default), one fetch."""
        x = torch.from_numpy(np.ascontiguousarray(crops, dtype=np.float32)).to(self.device)
        chunk = batch_size if batch_size is not None and batch_size < len(x) else len(x)
        decoded = torch.cat(
            [ctc_ops.ctc_greedy_decode(self.model(part)) for part in torch.split(x, chunk)]
        )
        return ctc_ops.ctc_decode_to_strings(decoded.cpu().numpy(), self.alphabet)

    def recognize(self, image) -> str:
        """The text of one pre-cropped image (a path or an array),
        letterboxed to the model's input size on a black canvas."""
        height, width, channels = self.input_shape
        image = tools.read_and_fit(filepath_or_array=image, width=width, height=height, cval=0)
        if channels == 1 and image.shape[-1] == 3:
            image = rgb_to_grayscale_host(image)[..., np.newaxis]
        image = image.astype("float32") / 255
        return self._predict_strings(image[np.newaxis])[0]

    def recognize_from_boxes(self, images, box_groups, **kwargs) -> typing.List[typing.List[str]]:
        """The text of each box of each image: one list of strings per
        image, in box order.

        The crops are cut on the host (:func:`..tools.warpBox`, from the
        grey image when the model has one channel) and read together in
        one device batch. ``batch_size`` chunks the device forward,
        ``verbose`` is accepted and ignored; any other keyword raises
        ``TypeError``.
        """
        batch_size = kwargs.pop("batch_size", None)
        kwargs.pop("verbose", None)
        if kwargs:
            raise TypeError(f"Unsupported recognize_from_boxes kwargs: {sorted(kwargs)}")
        if len(box_groups) != len(images):
            raise ValueError("You must provide the same number of box groups as images.")
        height, width, channels = self.input_shape
        crops = []
        start_end: typing.List[typing.Tuple[int, int]] = []
        for image, boxes in zip(images, box_groups):
            image = tools.read(image)
            if channels == 1 and image.shape[-1] == 3:
                image = rgb_to_grayscale_host(image)
            for box in boxes:
                crops.append(
                    tools.warpBox(
                        image=image, box=np.asarray(box, "float32"),
                        target_height=height, target_width=width,
                    )
                )
            start = start_end[-1][1] if start_end else 0
            start_end.append((start, start + len(boxes)))
        if not crops:
            return [[]] * len(images)
        X = np.array(crops, dtype="float32") / 255
        if X.ndim == 3:
            X = X[..., np.newaxis]
        predictions = self._predict_strings(X, batch_size)
        return [predictions[start:end] for start, end in start_end]

    def compile(self, optimizer=None, learning_rate: float = 1e-3, mesh=None):
        """Create (and return, as ``self.trainer``) the CTC trainer of this
        recognizer: ``optimizer`` is a callable from parameters to a
        ``torch.optim.Optimizer``, by default RMSprop at ``learning_rate``
        (the reference's Keras ``compile``). Train with
        ``self.trainer.fit(...)``."""
        from .train import RecognizerTrainer
        from .train.optim import RMSprop

        if optimizer is None:
            def optimizer(params):
                return RMSprop(params, lr=learning_rate)
        self.trainer = RecognizerTrainer(self, optimizer=optimizer, mesh=mesh)
        return self.trainer

    def max_string_length(self) -> int:
        """CTC frame count, ``width / pool**2 - rnn_steps_to_discard``: the
        longest label this model can emit."""
        params = self.build_params
        return int(params["width"] // params["pool_size"] ** 2 - params["rnn_steps_to_discard"])

    def _encode_label(self, sentence: str, pad_to: int) -> typing.List[int]:
        """Alphabet indices of a sentence, -1-padded to ``pad_to`` slots.
        Raises ``ValueError`` on what CTC training cannot take: an empty
        sentence, one longer than ``pad_to``, runs of spaces, characters
        outside the alphabet."""
        if not sentence:
            raise ValueError("Found a zero length sentence.")
        if len(sentence) > pad_to:
            raise ValueError("A sentence is longer than this model can predict.")
        if "  " in sentence:
            raise ValueError("Strings with multiple sequential spaces are not permitted.")
        bad = [c for c in sentence if c not in self.alphabet]
        if bad:
            raise ValueError(f"Found illegal character: {bad[0]}")
        return [self.alphabet.index(c) for c in sentence] + [-1] * (pad_to - len(sentence))

    def get_batch_generator(self, image_generator, batch_size=8, lowercase=False):
        """Training batches ``((images, labels, input_length, label_length),
        zeros)`` from ``(image, text)`` samples, or with ``sample_weights``
        appended from ``(image, text, weight)`` ones: uint8 RGB crops at the
        model's input size become float32 in [0, 1] (grey for a one-channel
        model), texts are stripped (and lowercased) and encoded."""
        frames = self.max_string_length()
        channels = self.input_shape[2]
        ctc_dummy_target = np.zeros((batch_size, 1))
        input_length = np.full((batch_size, 1), frames, dtype="float64")
        while True:
            samples = list(itertools.islice(image_generator, batch_size))
            texts = [sample[1].strip() for sample in samples]
            if lowercase:
                texts = [text.lower() for text in texts]
            planes = []
            for sample in samples:
                image = sample[0]
                if channels != 3:
                    image = rgb_to_grayscale_host(image)[..., np.newaxis]
                planes.append(image.astype("float32") / 255)
            images = np.array(planes)
            labels = np.array([self._encode_label(text, frames) for text in texts])
            label_length = np.array([[len(text)] for text in texts])
            inputs = (images, labels, input_length, label_length)
            if len(samples[0]) == 3:
                yield inputs, ctc_dummy_target, np.array([sample[2] for sample in samples])
            else:
                yield inputs, ctc_dummy_target

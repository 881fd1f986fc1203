"""Row strips of an image batch and the halo exchange between them.

No JAX counterpart: there ``Pipeline(mesh=...)`` puts the CRAFT input under
``spatial_sharding`` (height on ``model``) and XLA's SPMD partitioner
inserts a collective-permute of the rows each layer reads across a shard
edge. Here one Python process drives every device, so

* :class:`StripForward` cuts a batch into the row strips of
  :func:`.mesh.strip_bounds`, one a ``model`` device of a data position,
  and runs a model on them together, one thread a non-empty strip
  (:class:`StripGroup`, a :class:`.replicas.ReplicaGroup`); the outputs
  are gathered along the rows on the input's device.
* Inside such a forward a layer that reads rows across a strip edge asks
  :func:`current` for its group and takes its neighbours' rows at a
  meeting of all strips: :func:`apply` runs a function (one layer, or a
  chain of them) on the strip extended by ``rows`` rows of the strips
  above and below and keeps the strip's own rows of the result;
  :func:`apply_upsampled` does so for a decoder step, whose bilinear
  resize takes the rows the whole image's half-pixel taps read;
  :func:`same_rows` gives a strided TF "SAME" conv (EfficientNet's stem
  and stride-2 depthwise convs) the rows it reads, with the whole image's
  pads at the image's top and bottom (a strip-only function: unsharded,
  the conv pads its own input). Each strip hands the others its tensor
  itself;
  a strip copies only the rows it takes, and only where they lie on
  another device. A strip shorter than a halo takes rows from as many
  strips as the halo reaches. At the image's edges nothing is added: the
  layer pads there as it does unsharded (zeros for a conv, ``-inf`` for a
  max-pool, clamping for a resize).
* A mean over the whole image (EfficientNet's squeeze-excite) is a second
  kind of meeting: :func:`mean` adds every strip's sums of its own rows.
* Outside a strip forward these are the plain functions: the unsharded
  path is unchanged.

Running a chain of SAME layers on rows extended by the sum of their halos
and cropping after gives the unsharded rows exactly: a row wrong at the
extension's edge (padded where the image goes on) moves inwards one layer
at a time, by one row per layer's halo, and stays within the extension.
"""

from __future__ import annotations

import math
import threading
import typing

import torch

from ..ops import image as image_ops
from . import mesh as mesh_lib
from . import replicas


def current() -> typing.Optional[typing.Tuple["StripGroup", int]]:
    """The (group, rank) of the strip forward this thread runs, else None."""
    return replicas.current(StripGroup.context)


class _Strips:
    """What one meeting tells a strip of a tensor cut into row strips along
    ``dim``: every strip's part (a tensor, or its row count), where each
    starts, and the whole height."""

    def __init__(self, parts, rank: int, dim: int):
        self.parts, self.dim = parts, dim
        sizes = [p if isinstance(p, int) else p.shape[dim] for p in parts]
        self.offsets = [0]
        for size in sizes:
            self.offsets.append(self.offsets[-1] + size)
        self.start, self.stop = self.offsets[rank], self.offsets[rank + 1]
        self.total = self.offsets[-1]

    def rows(self, start: int, stop: int, device=None, out=None) -> torch.Tensor:
        """The whole tensor's rows ``[start, stop)``, clipped to it, from
        the strips that hold them: copied into ``out`` where given, else
        into a new contiguous tensor on ``device``. (Copies into one
        tensor, not ``torch.cat``: the strips' rows are views that are not
        contiguous across the batch, which ``torch.cat`` copies several
        times slower.)"""
        start, stop = max(0, start), min(self.total, stop)
        if out is None:
            like = self.parts[0]
            shape = list(like.shape)
            shape[self.dim] = stop - start
            out = torch.empty(shape, dtype=like.dtype, device=device)
        for part, lo, hi in zip(self.parts, self.offsets, self.offsets[1:]):
            a, b = max(lo, start), min(hi, stop)
            if a < b:
                out.narrow(self.dim, a - start, b - a).copy_(part.narrow(self.dim, a - lo, b - a))
        return out


class StripGroup(replicas.ReplicaGroup):
    """The threads of one strip forward, rank ``k`` the ``k``-th non-empty
    strip from the top; :meth:`strips` is their meeting.

    One thread runs at a time, in rank order: a rank runs until its next
    meeting (or its end) and hands a baton to the next rank that has not
    ended. Strips on one card share its stream, so nothing is lost on the
    device; on the host the running thread never waits for the
    interpreter lock of threads it has just woken (all ranks running at
    once made a forward on 4 strips of one card several times slower,
    PERF.md §6). The strips meet equally often (the same layers); the
    values of a meeting stay readable while the next is filled, in two
    alternating sets of slots. A rank that raises ends its turns, and the
    others raise ``BrokenBarrierError`` at their next turn."""

    context = "strip"

    def __init__(self, size: int):
        super().__init__(size)
        self._turns = [threading.Semaphore(0) for _ in range(size)]

    def run(self, fn):
        self._meetings = ([None] * self.size, [None] * self.size)
        self._count, self._ended, self._failed = [0] * self.size, [False] * self.size, False

        def turns(rank):
            try:
                if rank:
                    self._wait(rank)
                return fn(rank)
            except BaseException:
                self._failed = True
                raise
            finally:
                self._ended[rank] = True
                self._pass(rank)

        try:
            return super().run(turns)
        finally:
            # The last meetings' tensors are not kept past the run.
            self._meetings = ([None] * self.size, [None] * self.size)

    def _pass(self, rank: int) -> None:
        """Hand the baton to the next rank after ``rank`` that has not ended."""
        for step in range(1, self.size):
            other = (rank + step) % self.size
            if not self._ended[other]:
                self._turns[other].release()
                return

    def _wait(self, rank: int) -> None:
        self._turns[rank].acquire()
        if self._failed:
            raise threading.BrokenBarrierError

    def gather(self, rank: int, value) -> list:
        """Every rank's ``value``, in rank order: this rank's turn ends here
        and resumes once every rank has given its value."""
        slots = self._meetings[self._count[rank] % 2]
        self._count[rank] += 1
        slots[rank] = value
        self._pass(rank)
        self._wait(rank)
        return list(slots)

    def strips(self, rank: int, dim: int, *values) -> typing.List[_Strips]:
        """One meeting: for each of ``values`` (this strip's tensor, or its
        row count) a :class:`_Strips` of every strip's along ``dim``."""
        met = self.gather(rank, values)
        return [_Strips([m[i] for m in met], rank, dim) for i in range(len(values))]


def apply(fn, x: torch.Tensor, rows: int, dim: int = 1, shrink=1):
    """``fn(x)`` where ``x`` is a row strip: ``fn`` runs on ``x`` extended
    by up to ``rows`` rows of the strips above and below (none beyond the
    image), and the rows of ``x`` are kept of its result, its row ``i``
    being the extension's row ``shrink * i`` (2 after a fused 2x2 pool;
    ``rows`` must then be even). A tuple result is cropped entry by entry,
    with a tuple ``shrink``. Outside a strip forward, or with ``rows`` 0:
    ``fn(x)``."""
    strip = current()
    if strip is None or rows == 0:
        return fn(x)
    group, rank = strip
    (mine,) = group.strips(rank, dim, x)
    first = max(0, mine.start - rows)
    out = fn(mine.rows(first, mine.stop + rows, x.device))
    top, count = mine.start - first, x.shape[dim]

    def crop(y, factor):
        return y.narrow(dim, top // factor, count // factor)

    if isinstance(out, tuple):
        return tuple(crop(y, f) for y, f in zip(out, shrink))
    return crop(out, shrink)


def apply_upsampled(fn, y: torch.Tensor, skip: torch.Tensor, rows: int, dims=(1, 2),
                    channels: int = -1):
    """``fn(torch.cat([resize_bilinear(y, skip's height and width), skip],
    channels))``, a decoder step; ``dims`` names the height and width
    dimensions. In a strip forward, where ``y`` and ``skip`` are strips of
    two tensors, one meeting gives both: the resize's rows are the whole
    resize's (:func:`..ops.image.resize_rows`, from the rows of ``y``'s
    strips that its taps read), for ``skip``'s strip and ``rows`` more on
    each side, beside the same rows of ``skip``; ``fn`` runs on them and
    the strip's rows of its result are kept, as :func:`apply` keeps
    them."""
    hdim, wdim = dims
    strip = current()
    if strip is None:
        up = image_ops.resize_bilinear(y, skip.shape[hdim], skip.shape[wdim], dims)
        return fn(torch.cat([up, skip], channels))
    group, rank = strip
    source, target = group.strips(rank, hdim, y, skip)
    first, last = max(0, target.start - rows), min(target.total, target.stop + rows)
    lo, hi = image_ops.source_rows(source.total, target.total, first, last)
    up = image_ops.resize_rows(source.rows(lo, hi, y.device), lo, source.total, target.total,
                               first, last, skip.shape[wdim], dims)
    shape = list(up.shape)
    shape[channels] += skip.shape[channels]
    joined = torch.empty(shape, dtype=up.dtype, device=skip.device)
    joined.narrow(channels, 0, up.shape[channels]).copy_(up)
    target.rows(first, last, out=joined.narrow(channels, up.shape[channels],
                                               skip.shape[channels]))
    out = fn(joined)
    return out.narrow(hdim, target.start - first, target.stop - target.start)


def same_pads(size: int, kernel: int, stride: int) -> typing.Tuple[int, int]:
    """TF/Flax "SAME" padding of one dimension of ``size`` entries: the
    (before, after) pads that give ``ceil(size / stride)`` outputs,
    ``total // 2`` before and the rest after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def same_rows(x: torch.Tensor, kernel: int, stride: int, dim: int = 1) -> torch.Tensor:
    """In a strip forward, where ``x`` holds rows ``[start, stop)`` of the
    whole tensor: the whole tensor's rows that a "SAME" conv of ``kernel``
    rows at ``stride`` reads for its output rows ``[ceil(start / stride),
    ceil(stop / stride))``, from the strips that hold them at one meeting,
    with the whole height's pads (zeros, :func:`same_pads`) where they
    reach above the image's top or below its bottom and none at an inner
    edge. A conv with no padding along ``dim`` then gives the strip's rows
    of the whole conv. The pads come from the whole height, so an odd
    height's shift of the sampling grid reaches every strip."""
    group, rank = current()
    (mine,) = group.strips(rank, dim, x)
    before, _ = same_pads(mine.total, kernel, stride)
    lo = -(-mine.start // stride) * stride - before
    hi = (-(-mine.stop // stride) - 1) * stride - before + kernel
    shape = list(x.shape)
    shape[dim] = hi - lo
    out = x.new_zeros(shape)
    first, last = max(lo, 0), min(hi, mine.total)
    if first < last:
        mine.rows(first, last, out=out.narrow(dim, first - lo, last - first))
    return out


def mean(x: torch.Tensor, dims=(2, 3), dim: int = 2) -> torch.Tensor:
    """``x.mean(dims, keepdim=True)`` where ``dims`` include the rows,
    ``dim``. In a strip forward the mean over the whole image: each strip
    sums its own rows in at least float32, one meeting adds every strip's
    sums in rank order (as :meth:`.replicas.ReplicaGroup.batch_moments`
    adds BatchNorm's), and the total is divided by the whole image's count
    and rounded once to ``x``'s dtype. A strip of no rows adds zeros and
    divides by nothing of its own."""
    strip = current()
    if strip is None:
        return x.mean(dims, keepdim=True)
    group, rank = strip
    wide = torch.promote_types(x.dtype, torch.float32)
    met = group.gather(rank, (x.sum(dims, keepdim=True, dtype=wide), x.shape[dim]))
    total = sum(s.to(x.device) for s, _ in met)
    count = sum(n for _, n in met) * math.prod(x.shape[d] for d in dims if d != dim)
    return (total / count).to(x.dtype)


class StripForward:
    """A model's forward over the row strips of a data position's devices.

    ``devices`` are the position's ``model`` devices in order. A call
    ``forward(models, x)`` with ``models[k]`` the model on ``devices[k]``
    (the module, or its replica) cuts the NHWC batch ``x`` at
    :func:`.mesh.strip_bounds`, runs ``models[k]`` on strip ``k`` on its
    device, all non-empty strips together in a :class:`StripGroup` (under
    the caller's grad and inference modes), and returns the outputs
    concatenated along the rows on ``x``'s device. The groups live as long
    as this object, one for each count of non-empty strips; a lock lets one
    call at a time use them."""

    def __init__(self, devices):
        self.devices = list(devices)
        self._groups: typing.Dict[int, StripGroup] = {}
        self._lock = threading.Lock()

    def __call__(self, models, x: torch.Tensor) -> torch.Tensor:
        bounds = mesh_lib.strip_bounds(x.shape[1], len(self.devices))
        strips = [(lo, hi, device, model) for lo, hi, device, model
                  in zip(bounds, bounds[1:], self.devices, models) if hi > lo]
        inference, grad = torch.is_inference_mode_enabled(), torch.is_grad_enabled()

        def forward(rank):
            lo, hi, device, model = strips[rank]
            with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                return model(x[:, lo:hi].to(device))

        with self._lock:
            group = self._groups.get(len(strips))
            if group is None:
                group = self._groups[len(strips)] = StripGroup(len(strips))
            outs = group.run(forward)
        return torch.cat([out.to(x.device) for out in outs], 1)

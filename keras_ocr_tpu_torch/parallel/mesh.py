"""Device meshes and shardings of the port.

Counterpart of ``keras_ocr_tpu/parallel/mesh.py`` with JAX's names and
meanings, as PyTorch values. A :class:`Mesh` is a grid of devices with
named axes. The axes:

* ``data`` (and ``slice`` on a hybrid mesh): the batch is split over them
  (data parallel); each position runs its shard on the device at model
  index 0 (:func:`data_rows`);
* ``model``: the devices of one data position. The CRNN trainer's
  ``tensor_parallel`` splits the columns of the wide kernels over them
  (:func:`crnn_param_sharding`). The pipeline, where the axis has several
  devices, cuts each image of the position into row strips
  (:func:`strip_bounds`, JAX's :func:`spatial_sharding`), strip ``k`` on
  the position's ``k``-th ``model`` device, and runs CRAFT strip by strip
  with halo exchanges between neighbouring strips
  (:mod:`.halo`). The trainers keep one replica on the first device of
  each position.

A device may appear more than once: ``devices=[torch.device("cpu")] * 8``
makes the 8 fake devices the CPU tests use, ``[cuda:0, cuda:0]`` two
replicas on one card. :class:`Sharding` carries a ``PartitionSpec``'s
meaning (a tuple of axis names, or of tuples of names, per array axis).

Without a process group (or in a group of one) the mesh holds this
process's devices and one Python call drives them all, as JAX's single
controller does. Once :func:`initialize_distributed` has started a group of
several processes, :func:`create_mesh` and :func:`create_hybrid_mesh` build
the grid over every process's devices in rank order, as JAX's mesh spans
processes after ``jax.distributed.initialize``: a device of another process
is a :class:`RemoteDevice` that names its rank. The contract is JAX's
multi-controller one: every process makes the same calls with the same
global batch and runs the data positions whose devices it holds
(:func:`local_rows`; :func:`shard_batch` hands it their shards). A
``model`` row stays within one process (the trainers' tensor parallelism
and the strips' batons are in-process mechanisms), and
``create_hybrid_mesh(dcn_data=world_size)`` puts ``slice`` across the
processes, as JAX puts it on DCN. The process group is the caller's, with
the caller's backend: ``gloo`` on the CPU, ``nccl`` with one process per
card, ``gloo`` on CUDA tensors for several processes on one card.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import typing

import numpy as np
import torch

AxisSpec = typing.Union[None, str, typing.Tuple[str, ...]]


def canonical_device(device) -> torch.device:
    """The device a tensor moved to ``device`` reports: a CUDA device
    without index is the current one, a CPU device has no index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        return torch.device("cpu")
    return device


@dataclasses.dataclass(frozen=True)
class RemoteDevice:
    """A device of another process of the group: the process's rank and
    the device's name there. This process never places data on it."""

    process_index: int
    name: str

    def __str__(self):
        return f"{self.name}@{self.process_index}"


def process_count() -> int:
    """The processes of the running group (JAX's ``jax.process_count``):
    1 without a group."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the running group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if process_count() > 1 else 0


def is_local(device) -> bool:
    """Whether ``device`` of a mesh is this process's (not a
    :class:`RemoteDevice`)."""
    return not isinstance(device, RemoteDevice)


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``).

    ``devices`` is the numpy object array of ``torch.device`` (this
    process's) and :class:`RemoteDevice` (other processes'); ``shape`` an
    ordered dict from axis name to size; ``axis_names`` the names in order.
    """

    def __init__(self, devices, axis_names: typing.Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [d if isinstance(d, RemoteDevice) else torch.device(d) for d in grid.ravel()]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a {self.devices.ndim}-D "
                             f"device grid {self.devices.shape}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def spans_processes(self) -> bool:
        """Whether some device of the mesh is another process's."""
        return not all(is_local(d) for d in self.devices.ravel())

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.ravel()]})"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """``NamedSharding(mesh, PartitionSpec(*spec))``: entry ``i`` of
    ``spec`` names the mesh axis (or tuple of axes) that array axis ``i`` is
    split over, None where it is not split; missing entries are None."""

    mesh: Mesh
    spec: typing.Tuple[AxisSpec, ...] = ()


def _default_devices(devices):
    if devices is not None:
        return list(devices)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices=[torch.device(\"cpu\")] "
                           "* n to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(devices, shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    if int(np.prod(shape)) != grid.size:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {grid.size} devices")
    return grid.reshape(tuple(shape))


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)`` where a
    multi-process environment is set (``WORLD_SIZE`` above 1, or a
    ``world_size`` argument above 1) and no group is running; a no-op
    otherwise, as the JAX function is on one host. The backend, address,
    rank and world size are the caller's (``backend="gloo"``,
    ``init_method="tcp://localhost:<port>"``, ...): nothing is chosen
    here."""
    import torch.distributed as dist

    world = int(kwargs.get("world_size", os.environ.get("WORLD_SIZE", 1)))
    if world <= 1 or not dist.is_available() or dist.is_initialized():
        return
    dist.init_process_group(**kwargs)


def _process_devices(devices: list) -> list:
    """Every process's devices in rank order where a group of several
    processes runs (``all_gather_object`` of each one's list): this
    process's as given, the others' as :class:`RemoteDevice`; else
    ``devices`` themselves."""
    world = process_count()
    if world == 1:
        return devices
    import torch.distributed as dist

    names: list = [None] * world
    dist.all_gather_object(names, [str(torch.device(d)) for d in devices])
    rank = dist.get_rank()
    return [device for index, listed in enumerate(names)
            for device in (devices if index == rank
                           else [RemoteDevice(index, name) for name in listed])]


def _process_of(device) -> int:
    return device.process_index if isinstance(device, RemoteDevice) else process_index()


def _check_rows(mesh: Mesh) -> Mesh:
    """``mesh``, where each of its ``model`` rows lies within one process
    (or it holds this process's devices only, or has no batch axes);
    ``ValueError`` otherwise."""
    axes = set(mesh.axis_names)
    if not mesh.spans_processes or "data" not in axes or axes - {"slice", "data", "model"}:
        return mesh
    for row in _rows(mesh):
        if len({_process_of(d) for d in row}) > 1:
            raise ValueError(
                f"a 'model' row of {mesh} spans processes ({', '.join(map(str, row))}); "
                "tensor parallelism and row strips run within one process: give each "
                "process whole rows (create_hybrid_mesh(dcn_data=world_size, ...))")
    return mesh


def create_mesh(
    shape: typing.Optional[typing.Tuple[int, int]] = None,
    axis_names: typing.Tuple[str, str] = ("data", "model"),
    devices=None,
) -> Mesh:
    """A (data, model) mesh; by default every CUDA device on ``data``
    (``(n, 1)``). Without a card pass ``devices``. In a group of several
    processes ``devices`` are this process's, and the mesh holds every
    process's in rank order; a ``model`` row across processes raises
    ``ValueError``."""
    devices = _process_devices(_default_devices(devices))
    return _check_rows(Mesh(_grid(devices, shape or (len(devices), 1)), axis_names))


def create_hybrid_mesh(
    dcn_data: int = 1,
    ici_shape: typing.Optional[typing.Tuple[int, int]] = None,
    axis_names: typing.Tuple[str, ...] = ("slice", "data", "model"),
    devices=None,
) -> Mesh:
    """A (slice, data, model) mesh: ``dcn_data`` slices of ``ici_shape``
    (default: all of a slice's devices on ``data``), the devices grouped
    contiguously, as JAX groups devices without a slice topology. In a
    group of several processes the devices are every process's in rank
    order, so ``dcn_data=world_size`` makes each process a slice."""
    devices = _process_devices(_default_devices(devices))
    ici_shape = ici_shape or (len(devices) // dcn_data, 1)
    return _check_rows(Mesh(_grid(devices, (dcn_data,) + tuple(ici_shape)), axis_names))


def hybrid_batch_sharding(mesh: Mesh) -> Sharding:
    """The batch split over both data axes, ``slice`` major."""
    return Sharding(mesh, (("slice", "data"),))


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis split over every data-parallel axis:
    ``(slice, data)`` on a hybrid mesh, else ``data``."""
    if "slice" in mesh.axis_names:
        return hybrid_batch_sharding(mesh)
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def spatial_sharding(mesh: Mesh) -> Sharding:
    """An NHWC batch with the batch on ``data`` and the height on
    ``model``: what ``Pipeline(mesh=...)`` runs CRAFT on where ``model``
    has several devices (row strips, :func:`strip_bounds`)."""
    return Sharding(mesh, ("data", "model"))


# CRAFT's total stride (four 2x2 pools): strips cut at multiples of it give
# every pool and every 2x upsampling whole row pairs at every level.
STRIP_ROWS = 16


def strip_bounds(height: int, parts: int) -> typing.List[int]:
    """Row bounds of ``parts`` strips of an image ``height`` rows high:
    strip ``k`` is rows ``[bounds[k], bounds[k + 1])``. The inner bounds
    are multiples of :data:`STRIP_ROWS`, spread as evenly as they go; the
    last strip takes the remainder. A height below ``STRIP_ROWS * parts``
    leaves some strips empty."""
    units = height // STRIP_ROWS
    return [STRIP_ROWS * (k * units // parts) for k in range(parts)] + [height]


def data_size(mesh: Mesh) -> int:
    """The positions the batch is split over: ``slice`` x ``data``."""
    return mesh.shape.get("slice", 1) * mesh.shape["data"]


def _rows(mesh: Mesh) -> list:
    unknown = set(mesh.axis_names) - {"slice", "data", "model"}
    if "data" not in mesh.axis_names or unknown:
        raise ValueError(f"a batch mesh has a 'data' axis and optional 'slice' and 'model' "
                         f"axes; got {mesh.axis_names}")
    order = [mesh.axis_names.index(a) for a in ("slice", "data", "model") if a in mesh.axis_names]
    grid = np.transpose(mesh.devices, order).reshape(data_size(mesh), -1)
    return [list(row) for row in grid]


def data_rows(mesh: Mesh) -> list:
    """One list per data position, in batch order (``slice`` major): the
    devices of its ``model`` axis, in ``model`` order. A shard is uploaded
    to and post-processed on the first of them; the pipeline's CRAFT strips
    run on all of them. On a mesh across processes some rows are other
    processes' (:func:`local_rows`); ``ValueError`` where a row spans
    processes."""
    return _rows(_check_rows(mesh))


def local_rows(mesh: Mesh) -> typing.List[typing.Tuple[int, typing.List[torch.device]]]:
    """This process's data positions: (global index, row of devices) of
    each row whose devices are this process's, in batch order. Every row on
    a mesh of this process's devices only."""
    return [(index, row) for index, row in enumerate(data_rows(mesh)) if is_local(row[0])]


def local_indices(mesh: Mesh, size: int) -> torch.Tensor:
    """The samples of a global batch of ``size`` that this process's data
    positions hold: position ``i`` of ``n`` holds the ``i``-th of ``n``
    equal chunks. ``ValueError`` where the batch does not divide."""
    positions = data_size(mesh)
    if size % positions:
        raise ValueError(f"a batch of {size} does not divide over the {positions} data "
                         f"positions of {mesh}")
    chunk = size // positions
    return torch.cat([torch.arange(i * chunk, (i + 1) * chunk) for i, _ in local_rows(mesh)])


def shard_batch(batch, mesh: Mesh):
    """Split each array of a (nested tuple, list or dict) global ``batch``
    along its first axis over the data positions and keep this process's:
    each leaf becomes a list of tensors, one per :func:`local_rows` entry,
    on its row's first device (every shard on a mesh of this process's
    devices). Raises ``ValueError`` where a batch does not divide over the
    mesh's (global) positions, as ``jax.device_put`` does."""
    rows = local_rows(mesh)
    positions = data_size(mesh)

    def split(leaf):
        tensor = _tensor(leaf)
        if tensor.shape[0] % positions:
            raise ValueError(f"a batch of {tensor.shape[0]} does not divide over the "
                             f"{positions} data positions of {mesh}")
        parts = tensor.chunk(positions)
        return [parts[index].to(row[0]) for index, row in rows]

    return _tree_map(split, batch)


def _tensor(leaf) -> torch.Tensor:
    return leaf if torch.is_tensor(leaf) else torch.from_numpy(np.array(leaf))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value, *(r[key] for r in rest)) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def _model_sharded(name: str, shape, model_size: int) -> bool:
    """JAX's selection: the 2-D kernels of ``fc_9``, ``fc_12`` and the LSTMs
    whose columns divide the ``model`` axis."""
    return (
        len(shape) == 2
        and shape[1] % model_size == 0
        and ("fc_9/kernel" in name or "fc_12/kernel" in name
             or ("lstm" in name and name.endswith("kernel")))
    )


def crnn_param_sharding(mesh: Mesh):
    """Tensor-parallel rules of a CRNN variable tree (the JAX layout):
    column-parallel (``(None, "model")``) on the wide dense and LSTM
    kernels, everything else replicated. Returns a function from a tree to
    the tree of :class:`Sharding`."""
    model_size = mesh.shape.get("model", 1)

    def apply(tree, path=()):
        if isinstance(tree, dict):
            return {key: apply(value, path + (str(key),)) for key, value in tree.items()}
        if _model_sharded("/".join(path), np.shape(tree), model_size):
            return Sharding(mesh, (None, "model"))
        return replicated(mesh)

    return apply


def shard_params(variables, mesh: Mesh, rules=None) -> list:
    """One fresh copy of a variable tree per mesh device, in mesh order
    (``mesh.devices.ravel()``): each leaf a new tensor on that device,
    whole where its sharding is replicated, its block of columns (by the
    device's ``model`` index) where a rule (:func:`crnn_param_sharding`)
    splits it. Default: every leaf replicated. Another process's device
    gets None."""
    specs = rules(variables) if rules is not None else _tree_map(lambda _: replicated(mesh),
                                                                 variables)
    names = mesh.axis_names
    copies = []
    for index in np.ndindex(mesh.devices.shape):
        device = mesh.devices[index]
        if not is_local(device):
            copies.append(None)
            continue

        def put(leaf, sharding):
            tensor = _tensor(leaf)
            for axis, entry in enumerate(sharding.spec):
                for name in (entry,) if isinstance(entry, str) else (entry or ()):
                    tensor = tensor.chunk(mesh.shape[name], axis)[index[names.index(name)]]
            return tensor.to(device, copy=True)

        copies.append(_tree_map(put, variables, specs))
    return copies


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself where it is a :class:`Mesh`; ``TypeError`` otherwise."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a keras_ocr_tpu_torch.parallel.Mesh (create_mesh, "
                        f"create_hybrid_mesh), got {type(mesh).__name__}")
    return mesh

"""Module replicas on a mesh and their cross-replica reductions.

No JAX counterpart: there XLA's SPMD partitioner splits one program over
the mesh. Here each process drives its own devices of the mesh
(:func:`.mesh.local_rows`: every device without a process group), so

* :class:`ModuleReplicas` keeps one copy of a module per device, for the
  pipeline's inference: the module itself on its own device, a copy on each
  other device (a device named several times shares one), copied again from
  the module when one of its tensors changed. Per-tensor caches of the
  kernels (``ops/conv_cuda.py:prepared_weight``, ``models/craft.py:_chain_conv``)
  thus stay per replica.
* :class:`ReplicaGroup` runs the training forwards of this process's
  shards together, one thread a shard, which meet at each cross-replica
  reduction: :class:`..models.layers.BatchNorm2d` in training mode asks
  :func:`current` for its group and takes its batch statistics over the
  whole global batch (:meth:`ReplicaGroup.batch_moments`), as a BatchNorm
  under ``jit`` does on a batch-sharded array. Each thread reads the others'
  partial sums as graph tensors, so one backward over every shard's output
  differentiates the global statistics. On a mesh across processes the
  process's sum then goes through one ``all_reduce`` of the process group
  (:func:`all_reduce_sum`, whose backward all-reduces the gradient), so the
  backward meets the other processes once per such sum, in the reverse of
  the forward's order on every process.
* :class:`DataParallel` runs a module's training forward on this process's
  data positions: the parameters stay on the module's device, each shard
  runs ``torch.func.functional_call`` of its own replica with the
  parameters moved to the shard's device, so that backward reduces the
  gradients into the module's own through the moves. Across processes the
  trainers then add every process's gradients
  (:func:`all_reduce_gradients`).

The pipeline's spatial sharding runs on a kind of group of its own: one
thread a row strip of the images, each strip on its own ``model`` device
with its device's replica, the threads taking turns and meeting at every
layer that reads rows across a strip edge to take their neighbours' rows
(:class:`.halo.StripGroup`, whose threads see it as
:func:`.halo.current`).
"""

from __future__ import annotations

import concurrent.futures
import copy
import threading
import typing

import torch

from . import mesh as mesh_lib

_local = threading.local()


def current(context: str = "replica") -> typing.Optional[typing.Tuple["ReplicaGroup", int]]:
    """The (group, rank) of the ``context`` this thread runs in (a
    :class:`ReplicaGroup`'s replica forward; ``"strip"``: a
    :class:`.halo.StripGroup`'s strip), else None."""
    return getattr(_local, context, None)


def _tensors(module: torch.nn.Module):
    return list(module.parameters()) + list(module.buffers())


def _stamp(module: torch.nn.Module) -> tuple:
    """Identity and version of each tensor of ``module``: changes when a
    tensor is replaced or written in place."""
    return tuple((id(t), t._version) for t in _tensors(module))


class ModuleReplicas:
    """Copies of a module on other devices, kept equal to it: :meth:`get`
    returns the module itself on its own device, elsewhere one copy per
    device, made at first use and copied again from the module whenever
    one of its tensors was replaced or written."""

    def __init__(self):
        self._copies: dict = {}
        self._lock = threading.Lock()

    def get(self, module: torch.nn.Module, device) -> torch.nn.Module:
        tensors = _tensors(module)
        if not tensors or (mesh_lib.canonical_device(device)
                           == mesh_lib.canonical_device(tensors[0].device)):
            return module  # on its own device, or nothing to copy
        device = mesh_lib.canonical_device(device)
        # Made and written as normal tensors, also under inference mode.
        with self._lock, torch.inference_mode(False), torch.no_grad():
            entry = self._copies.get(device)
            if entry is None or entry[0] is not module:
                entry = self._copies[device] = [module, copy.deepcopy(module).to(device), None]
            stamp = _stamp(module)
            if entry[2] != stamp:
                for target, source in zip(_tensors(entry[1]), _tensors(module)):
                    target.copy_(source)
                entry[1].train(module.training)
                entry[2] = stamp
        return entry[1]


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the processes of the group. Its gradient is the
    sum of every process's incoming gradient: each process's loss holds its
    own share of the global loss, so the global loss's gradient with
    respect to the sum is the sum of the shares' gradients."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes of the running group, differentiable
    (one ``all_reduce`` forward, one backward); ``x`` itself without a
    group of several processes."""
    return _AllReduceSum.apply(x) if mesh_lib.process_count() > 1 else x


def all_reduce_gradients(params: typing.Iterable[torch.nn.Parameter]) -> None:
    """Add every process's ``.grad`` into each process's: one flat buffer
    and one ``all_reduce`` per gradient dtype and device, in the
    parameters' order. Parameters without a gradient take no part (every
    process runs the same graph, so they are the same ones)."""
    if mesh_lib.process_count() == 1:
        return
    import torch.distributed as dist

    buckets: dict = {}
    for param in params:
        if param.grad is not None:
            buckets.setdefault((param.grad.dtype, param.grad.device), []).append(param.grad)
    for key in sorted(buckets, key=str):
        grads = buckets[key]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        for grad, part in zip(grads, flat.split([g.numel() for g in grads])):
            grad.copy_(part.view_as(grad))


class ReplicaGroup:
    """Runs one function per shard, all at once, meeting at :meth:`gather`:
    rank 0 in the calling thread, the others in worker threads that live
    as long as the group, so that per-thread caches (cuDNN's execution
    plans are kept per thread) outlast a step. An exception in one rank
    breaks the barrier for the others and is raised by :meth:`run`.
    ``context`` names the thread-local slot :func:`current` reads. With
    ``across_processes`` the group is this process's part of a mesh across
    processes, and its reductions add the other processes' sums."""

    context = "replica"

    def __init__(self, size: int, across_processes: bool = False):
        self.size = size
        self.across_processes = across_processes
        self._barrier = threading.Barrier(size)
        self._slots: list = [None] * size
        self._pool = (concurrent.futures.ThreadPoolExecutor(size - 1, "replica")
                      if size > 1 else None)

    def run(self, fn: typing.Callable[[int], typing.Any]) -> list:
        """``[fn(0), ..., fn(size - 1)]``, run together, each with this
        group as :func:`current` of its ``context``."""

        def work(rank):
            outer = current(self.context)
            setattr(_local, self.context, (self, rank))
            try:
                return fn(rank)
            except BaseException:
                self._barrier.abort()  # the other ranks stop waiting for this one
                raise
            finally:
                setattr(_local, self.context, outer)

        futures = [self._pool.submit(work, rank) for rank in range(1, self.size)]
        results, errors = [None] * self.size, []
        try:
            results[0] = work(0)
        except BaseException as exc:  # raised below, once the other ranks are done
            errors.append(exc)
        for rank, future in enumerate(futures, start=1):
            try:
                results[rank] = future.result()
            except BaseException as exc:
                errors.append(exc)
        self._barrier.reset()
        if errors:
            # The first error that is not another rank's broken barrier.
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return results

    def gather(self, rank: int, value) -> list:
        """Every rank's ``value``, in rank order, once all have given one."""
        self._slots[rank] = value
        self._barrier.wait()
        values = list(self._slots)
        self._barrier.wait()  # all have read before any writes again
        return values

    def batch_moments(self, rank: int, x: torch.Tensor):
        """Per-channel mean and biased variance of an NCHW ``x`` across
        every rank's ``x`` (the global batch), in two passes as
        ``torch.var_mean``: the (sum, count) pass, then the centred-sum
        pass. Each rank gets them on its own device. A shard's sums are at
        least float32 (a bfloat16 ``x`` is promoted, as Flax's statistics
        and XLA's cross-device sums are); the shards' sums are added in
        float64 (:meth:`_sum`), and the statistics rounded once to ``x``'s
        (promoted) dtype."""
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        count = x.numel() // x.shape[1]
        sums = self.gather(rank, (x.sum(dims), count))
        mean, total = self._sum(rank, [s for s, _ in sums], sum(n for _, n in sums), x.device)
        mean = (mean / total).to(x.dtype)
        centred = (x - mean.reshape(1, -1, 1, 1)).square().sum(dims)
        var, _ = self._sum(rank, self.gather(rank, centred), None, x.device)
        return mean, (var / total).to(x.dtype)

    def _sum(self, rank: int, parts: list, count, device):
        """(every rank's ``parts`` added, ``count``) on ``device``. Rank 0
        adds them once for all ranks, in rank order in float64, where float32
        sums add without rounding, so that the total (and the gradient that
        backward adds into it) does not depend on how the shards are split
        over devices or processes. Across processes it then all-reduces the
        total, ``count`` appended, in one ``all_reduce``
        (:func:`all_reduce_sum`). Every rank reads the result."""
        total = None
        if rank == 0:
            total = sum(p.to(device, torch.float64) for p in parts)
            if self.across_processes:
                if count is not None:
                    total = torch.cat([total, total.new_full((1,), count)])
                total = all_reduce_sum(total)
        total = self.gather(rank, total)[0].to(device)
        if self.across_processes and count is not None:
            return total[:-1], total[-1]
        return total, count


class DataParallel:
    """The training forward of ``module`` over this process's data
    positions of a mesh (all of them on a mesh of this process's devices).

    Each such position has a replica of ``module`` on its first device (a
    copy whose own tensors are never read: ``functional_call`` swaps in the
    module's parameters, moved to that device, and its buffers as they are,
    so that one BatchNorm updates the module's running statistics).
    ``configure(replica, row)`` may adapt each replica to its row of
    ``model``-axis devices (tensor parallelism). ``positions`` are the
    positions' global indices, ``devices`` their first devices."""

    def __init__(self, module: torch.nn.Module, mesh, configure=None):
        self.module = module
        self.mesh = mesh
        local = mesh_lib.local_rows(mesh)
        if not local:
            raise ValueError(f"{mesh} holds no device of this process")
        self.positions = [index for index, _ in local]
        self.rows = [row for _, row in local]
        self.devices = [row[0] for row in self.rows]
        self.across_processes = mesh.spans_processes
        self.replicas = []
        for row in self.rows:
            replica = copy.deepcopy(module).to(row[0])
            if configure is not None:
                configure(replica, row)
            self.replicas.append(replica)
        self.group = ReplicaGroup(len(self.rows), self.across_processes)

    def __call__(self, shards: typing.Sequence[tuple], kwargs=None) -> list:
        """``module(*shards[i], **kwargs[i])`` on each data position's
        device, all together; the outputs in shard order."""
        params = dict(self.module.named_parameters())
        buffers = dict(self.module.named_buffers())
        moved = {device: {name: p.to(device) for name, p in params.items()}
                 for device in dict.fromkeys(self.devices)}
        kwargs = kwargs or [{}] * len(shards)

        def forward(rank):
            replica = self.replicas[rank]
            replica.train(self.module.training)
            tensors = {**moved[self.devices[rank]], **buffers}
            return torch.func.functional_call(replica, tensors, shards[rank], kwargs[rank])

        return self.group.run(forward)


def column_parallel(fn, x: torch.Tensor, weight: torch.Tensor, bias, devices):
    """``fn(x, weight, bias)`` with the rows of ``weight`` (the columns of
    JAX's kernel) and of ``bias`` split into ``len(devices)`` contiguous
    blocks, block ``k`` computed on ``devices[k]`` and the results gathered
    on ``x``'s device along the last axis."""
    parts = len(devices)
    biases = bias.chunk(parts) if bias is not None else [None] * parts
    return torch.cat([
        fn(x.to(device), w.to(device), None if b is None else b.to(device)).to(x.device)
        for w, b, device in zip(weight.chunk(parts), biases, devices)
    ], -1)

"""The rings and meshes of ranks that the decompositions run on: the
port's counterpart of ``lax.ppermute`` on a mesh axis, ``lax.psum`` and
``lax.axis_index`` (``meso_tpu/parallel/domain.py``, ``domain2d.py``,
``domain3d.py``, ``ensemble.py``).

A ``Ring`` wraps a ``torch.distributed`` process group. ``exchange`` sends
one list of tensors to each named neighbour (+1: the next rank, -1: the
previous one) and receives the same shapes from the opposite neighbour,
as ``ppermute`` with the permutation i -> i + d does. Each direction's
tensors travel as one packed message, tagged by direction, so at two
ranks, where both neighbours are the same process, the left- and
right-going messages stay apart.

Gloo's point-to-point operations take CPU tensors only, and NCCL refuses
two ranks on one card; so where the backend is gloo and the tensors live
on the card, each message is staged through pinned host memory: copied off
the card on the current stream, sent by gloo, copied back. That staging is
gloo's transport, not a fallback; under NCCL the device buffers are sent
directly. ``exchange`` returns before the host waits, so a caller can
queue device work (the interior force launch) between the copy off the
card and ``Pending.wait``. A ring of one rank returns its input, as
``ppermute`` does on one device, and needs no process group.

A ``Mesh`` arranges the ranks of the default group as an array of shape
(n0, n1[, n2]) in row-major order, as a JAX ``Mesh`` of that shape holds
its devices, and gives each named axis a ``Ring``: the ranks that differ
only in that axis's coordinate, as one process group
(``dist.new_group``, which every rank calls for every such group, in the
same order). A sub-ring's neighbours are ranks of its own group; its
point-to-point operations name them by their global rank. ``all_sum`` and
``all_max`` over several axes reduce over each axis's ring in turn, as
JAX's nested ``psum`` does.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

_ALIGN = 8   # bytes: every packed segment starts at a multiple of this


def _pack(tensors) -> tuple[torch.Tensor, list]:
    """One uint8 buffer holding the tensors' bytes, each segment padded to
    ``_ALIGN``, and the (dtype, shape, offset) of each."""
    parts, layout, off = [], [], 0
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % _ALIGN
        parts.append(b)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=b.device))
        layout.append((t.dtype, tuple(t.shape), off))
        off += b.numel() + pad
    return torch.cat(parts), layout


def _unpack(buf: torch.Tensor, layout) -> list:
    out = []
    for dtype, shape, off in layout:
        n = torch.Size(shape).numel() * dtype.itemsize
        out.append(buf[off:off + n].view(dtype).reshape(shape))
    return out


class Pending:
    """An exchange in flight. ``wait()`` finishes it and returns
    {direction: received tensors}, on the device they were sent from,
    passed through the functions given to ``then``."""

    def __init__(self, finish: Callable[[], dict]):
        self._finish = finish
        self._after: list[Callable] = []

    def then(self, fn: Callable) -> "Pending":
        self._after.append(fn)
        return self

    def wait(self):
        with torch.profiler.record_function("ring_exchange"):
            out = self._finish()
        for fn in self._after:
            out = fn(out)
        return out


class Ring:
    """The ranks of a process group as a 1-D ring. ``Ring()`` takes the
    default group, ``Ring.single()`` is a ring of one with no group."""

    def __init__(self, group=None, _single: bool = False):
        self.group = group
        if _single:
            self.rank, self.size, self.backend = 0, 1, None
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            self.backend = dist.get_backend(group)

    @staticmethod
    def single() -> "Ring":
        return Ring(_single=True)

    def global_rank(self, group_rank: int) -> int:
        """The default group's rank of this ring's rank ``group_rank``:
        ``P2POp`` names its peer so."""
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def _staged(self, device: torch.device) -> bool:
        return self.backend == "gloo" and device.type != "cpu"

    def exchange(self, sends: dict) -> Pending:
        """Send ``sends[d]`` (a list of tensors, the same shapes on every
        rank) to rank + d for each direction d in {+1, -1}; receive the
        list rank - d sent. Returns the exchange in flight."""
        if self.size == 1:
            got = {d: list(ts) for d, ts in sends.items()}
            return Pending(lambda: got)
        packed = {d: _pack(ts) for d, ts in sends.items()}
        device = next(iter(packed.values()))[0].device
        staged = self._staged(device)
        bufs, recvs = {}, {}
        for d, (buf, _) in packed.items():
            if staged:
                host = torch.empty(buf.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(buf, non_blocking=True)
                buf = host
            bufs[d] = buf
            recvs[d] = torch.empty(buf.shape, dtype=torch.uint8,
                                   pin_memory=staged, device=buf.device)
        copied = None
        if staged:
            copied = torch.cuda.Event()
            copied.record()

        def finish():
            if copied is not None:
                copied.synchronize()
            ops = []
            for d in bufs:
                tag = 1 if d > 0 else 2
                ops.append(dist.P2POp(
                    dist.isend, bufs[d],
                    self.global_rank((self.rank + d) % self.size),
                    self.group, tag))
                ops.append(dist.P2POp(
                    dist.irecv, recvs[d],
                    self.global_rank((self.rank - d) % self.size),
                    self.group, tag))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            out = {}
            for d, (_, layout) in packed.items():
                buf = recvs[d]
                if staged:
                    buf = buf.to(device, non_blocking=True)
                out[d] = _unpack(buf, layout)
            return out

        return Pending(finish)

    def shift(self, tensors, direction: int) -> list:
        """``ppermute`` by ``direction``: each rank's ``tensors`` go to rank
        + direction; returns what rank - direction sent."""
        return self.exchange({direction: list(tensors)}).wait()[direction]

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return t
        buf = t.to("cpu") if self._staged(t.device) else t.clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``psum`` over the ring."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """``pmax`` over the ring."""
        return self._reduce(t, dist.ReduceOp.MAX)


def make_ring(world_size: int, rank: int, init_method: str,
              backend: str = "gloo", timeout_s: float = 60.0) -> Ring:
    """Join the process group of ``world_size`` ranks at ``init_method``
    (a ``file://`` path or ``tcp://localhost:<port>``) as ``rank`` and
    return its ring; collectives that wait longer than ``timeout_s``
    raise. Stands where ``make_mesh_1d`` stood."""
    from datetime import timedelta
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return Ring()


class Mesh:
    """The ranks of the default group as a row-major array of ``shape``
    with one named ``Ring`` per axis; every rank makes it with the same
    arguments. ``coords[name]`` is this rank's index along an axis
    (``lax.axis_index``); ``ring(name)`` the ranks of its line along that
    axis, whose ring rank is that index (a ring of one for an axis of
    one rank). Stands where ``make_mesh_2d``, ``make_mesh_3d`` and the
    ensembles' meshes stood."""

    def __init__(self, shape: tuple, names: tuple):
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "must pair up, the names distinct")
        self.shape, self.names = tuple(shape), tuple(names)
        size = 1
        for n in self.shape:
            size *= n
        world = Ring()
        self.rank = world.rank
        if world.size != size:
            raise ValueError(f"mesh {shape} needs {size} ranks, the group "
                             f"has {world.size}")
        self.size = size
        strides = [1] * len(shape)
        for a in range(len(shape) - 2, -1, -1):
            strides[a] = strides[a + 1] * shape[a + 1]
        self.coords = {nm: (self.rank // st) % n for nm, st, n in
                       zip(names, strides, shape)}
        self.rings = {}
        for a, (nm, n) in enumerate(zip(names, shape)):
            if n == 1:
                self.rings[nm] = Ring.single()
                continue
            # every line of ranks along axis a, each a group, created by
            # every rank in the same order
            others = [r for r in range(size) if (r // strides[a]) % n == 0]
            for first in others:
                line = [first + i * strides[a] for i in range(n)]
                group = dist.new_group(line)
                if self.rank in line:
                    self.rings[nm] = Ring(group)

    def ring(self, name: str) -> Ring:
        return self.rings[name]

    def _reduce(self, t, axes, fn):
        for name in self.names if axes is None else axes:
            t = fn(self.rings[name], t)
        return t

    def all_sum(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """``psum`` over ``axes`` (every axis where None), one axis's ring
        at a time."""
        return self._reduce(t, axes, Ring.all_sum)

    def all_max(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """``pmax`` over ``axes`` (every axis where None)."""
        return self._reduce(t, axes, Ring.all_max)

"""A device mesh over a ``torch.distributed`` world, and a launcher that
runs a function on a world of N ranks.

The counterpart of the reference package's ``launch/mesh.py``
(``make_production_mesh``, ``make_local_mesh``, ``data_axes``,
``dp_size``, ``tp_size``).  A :class:`Mesh` lays the world's ranks out
row-major on a ``("data", "model")`` or ``("pod", "data", "model")``
grid: rank ``r`` of a ``(d, m)`` mesh sits at ``(r // m, r % m)``.  Each
axis has one process group per line of the grid (the ranks that differ
only in that axis's coordinate), and a mesh with a ``pod`` axis has one
more group per ``model`` coordinate over both data axes; all are created
in the same order on every rank, as ``torch.distributed.new_group``
demands.  It is written on plain process groups rather than
``torch.distributed.device_mesh.DeviceMesh``, which maps ranks to cards
by rank; here several ranks may share one card (gloo) and the CPU tests
run gloo worlds with no card at all.  :class:`MeshShape` is the same
layout with no process groups (the dry run's mesh).

Backends: ``gloo`` runs on the CPU and, staging CUDA tensors through host
memory, with several ranks on one card; ``nccl`` runs one rank per card.
The backend is always the caller's explicit choice: nothing switches to
another backend or to the CPU.

    results = run_world(fn, 4, backend="gloo", timeout=300.0, args=(cfg,))

runs ``fn(rank, world_size, *args)`` in 4 spawned processes that meet on
a ``FileStore`` in a temporary directory, and returns each rank's result.

Importing this module starts no process group and no process.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "MeshShape", "make_production_mesh", "make_local_mesh",
           "data_axes", "dp_size", "tp_size", "pmean", "run_world",
           "RankError"]

AXES = ("pod", "data", "model")


def _axes_for(shape) -> tuple:
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh has 2 or 3 axes {AXES}, got shape "
                         f"{tuple(shape)}")
    return AXES[-len(shape):]


class MeshShape:
    """A mesh's layout with no process groups: ``shape``, ``axis_names``
    and the coordinates of ``rank`` (default 0), row-major as in
    :class:`Mesh`.  The dry run builds one rank's shards on it."""

    def __init__(self, shape, rank: int = 0, axis_names=None):
        shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names or _axes_for(shape))
        if len(self.axis_names) != len(shape) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} does not fit the axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.size = int(np.prod(shape))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside the mesh {shape}")
        self.rank = rank
        self._coords = dict(zip(self.axis_names,
                                np.unravel_index(rank, shape)))
        self._coords = {a: int(c) for a, c in self._coords.items()}

    def coord(self, axis: str) -> int:
        return self._coords[axis]

    def __repr__(self):
        return f"{type(self).__name__}({self.shape}, rank={self.rank})"


class Mesh(MeshShape):
    """A ``(data, model)`` or ``(pod, data, model)`` grid over the ranks of
    the initialized world.

    ``shape`` maps axis name to size; ``coord(axis)`` is this rank's
    coordinate on an axis and ``group(axis)`` the process group of the
    ranks that share its other coordinates; ``group(data_axes(mesh))`` on a
    three-axis mesh is the group over both data axes.  Building one calls
    ``torch.distributed.new_group`` for every line of every axis, so every
    rank of the world must build the same meshes in the same order."""

    def __init__(self, shape, axis_names=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "Mesh needs an initialized torch.distributed world "
                "(torch.distributed.init_process_group, or run_world)")
        shape = tuple(int(n) for n in shape)
        world = dist.get_world_size()
        if min(shape) < 1 or int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} does not cover the "
                             f"world of {world} ranks")
        super().__init__(shape, dist.get_rank(), axis_names)
        self._groups: Dict[Any, Any] = {}
        grid = np.arange(world).reshape(shape)
        lines = [(a,) for a in self.axis_names]
        data = data_axes(self)
        if len(data) > 1:
            lines.append(data)
        for axes in lines:
            # the ranks that differ only in ``axes``: one group per
            # combination of the other coordinates, in row-major order
            dims = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(shape)) if i not in dims]
            g_of = np.moveaxis(grid, rest + dims, range(len(shape)))
            g_of = g_of.reshape(-1, int(np.prod([shape[i] for i in dims])))
            mine = tuple(self._coords[self.axis_names[i]] for i in rest)
            for n, members in enumerate(g_of):
                g = dist.new_group([int(r) for r in members])
                if n == (np.ravel_multi_index(mine, [shape[i] for i in rest])
                         if rest else 0):
                    self._groups[axes if len(axes) > 1 else axes[0]] = g

    def group(self, axis):
        """The group of ``axis`` (a name), or of several data axes (a
        tuple; a one-name tuple is that axis's group)."""
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        return self._groups[axis]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self._coords}, backend={dist.get_backend()})")


def make_production_mesh(*, multi_pod: bool = False, shape=None) -> Mesh:
    """The reference's production layouts over an initialized world of
    exactly that many ranks: ``(16, 16)`` ``("data", "model")``, or with
    ``multi_pod`` ``(2, 16, 16)`` ``("pod", "data", "model")``; ``shape``
    overrides either (e.g. ``(64, 4)``).  A world of another size raises
    ``ValueError`` naming both sizes."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    shape = tuple(int(n) for n in shape)
    _axes_for(shape)
    need = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks; this world has {world}")
    return Mesh(shape)


def make_local_mesh(model_axis: int = 1) -> Mesh:
    """A mesh over the whole world: ``(world // model_axis, model_axis)``."""
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide the "
                         f"world of {n} ranks")
    return Mesh((n // model_axis, model_axis))


def data_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes of a mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_size(mesh: Mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def tp_size(mesh: Mesh) -> int:
    return int(mesh.shape.get("model", 1))


def pmean(mesh: Mesh, axis, loss: torch.Tensor,
          grads: Dict[str, torch.Tensor]):
    """``(loss, grads)`` averaged over ``axis``'s group (an axis name, or a
    tuple of data axes) in one all-reduce, so that every rank of the group
    applies the same update."""
    n = int(np.prod([mesh.shape[a] for a in
                     ((axis,) if isinstance(axis, str) else axis)]))
    flat = torch.cat([g.reshape(-1) for g in grads.values()] + [loss.reshape(1)])
    dist.all_reduce(flat, group=mesh.group(axis))
    flat = flat / n
    parts = torch.split(flat[:-1], [g.numel() for g in grads.values()])
    return flat[-1], {k: p.reshape(g.shape)
                      for (k, g), p in zip(grads.items(), parts)}


# --------------------------------------------------------------------------- #
# Launcher
# --------------------------------------------------------------------------- #
class RankError(RuntimeError):
    """A rank of a :func:`run_world` world raised; the message names the rank
    and carries its traceback."""


def _rank_main(rank: int, world: int, backend: str, store_path: str,
               timeout_s: float, fn: Callable, args: Sequence, results) -> None:
    def report(status: str, payload) -> None:
        results.put((rank, status, payload))
        # in the pipe before this rank's process group goes down, so that a
        # failing rank's report comes before its peers' lost connections
        results.close()
        results.join_thread()

    def describe(e: BaseException) -> str:
        return f"{type(e).__name__}: {e}\n{traceback.format_exc()}"

    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(0)         # ranks that share one card
        else:
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:                   # noqa: BLE001 - re-raised in the parent
        report("error", describe(e))
        return
    try:
        out = pickle.dumps(fn(rank, world, *args))
    except BaseException as e:               # noqa: BLE001 - re-raised in the parent
        report("error", describe(e))
        if not isinstance(e, Exception):
            raise
        return
    finally:
        dist.destroy_process_group()
    report("ok", out)


def run_world(fn: Callable, world_size: int, *, backend: str,
              timeout: float = 600.0, args: Sequence = ()) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks of a
    ``torch.distributed`` world on ``backend`` and return their results in
    rank order.

    The ranks meet on a ``FileStore`` in a fresh temporary directory (no
    TCP port, so concurrent worlds cannot collide).  ``fn`` and ``args``
    must pickle (``fn`` by import path); each result is pickled back.  CPU
    ranks run one thread each; on a CUDA machine every rank runs on card 0.
    A rank that raises fails the world: :class:`RankError` names it with
    its traceback, and the other ranks are killed.  ``timeout`` (seconds)
    bounds the whole world, the collectives' own timeout included; past
    it the ranks are killed and ``TimeoutError`` is raised."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; expected 'gloo' or "
                         f"'nccl'")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    procs = []
    try:
        store = os.path.join(tmp, "store")
        for r in range(world_size):
            p = ctx.Process(target=_rank_main,
                            args=(r, world_size, backend, store, timeout, fn,
                                  tuple(args), results),
                            daemon=False)
            p.start()
            procs.append(p)
        got: Dict[int, Tuple[str, Any]] = {}
        deadline = time.monotonic() + timeout
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {world_size} {backend} ranks did not finish in "
                    f"{timeout:.0f} s; ranks done: {sorted(got)}")
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    # a rank that died without reporting (killed, or lost)
                    time.sleep(1.0)
                    try:
                        while True:
                            rank, status, payload = results.get_nowait()
                            got[rank] = (status, payload)
                    except queue.Empty:
                        pass
                    dead = [r for r in dead if r not in got]
                    if dead:
                        raise RankError(
                            f"rank {dead[0]} of {world_size} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                continue
            got[rank] = (status, payload)
            if status == "error":
                raise RankError(f"rank {rank} of {world_size} ({backend}) "
                                f"failed: {payload}")
        for p in procs:
            p.join(timeout=30)
        return [pickle.loads(got[r][1]) for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)

"""A two-axis device mesh over a ``torch.distributed`` world, and a launcher
that runs a function on a world of N ranks.

The counterpart of the reference package's ``launch/mesh.py``
(``make_local_mesh``, ``data_axes``, ``dp_size``, ``tp_size``).  A
:class:`Mesh` lays the world's ranks out row-major on a
``("data", "model")`` grid: rank ``r`` sits at ``(r // m, r % m)`` of a
``(d, m)`` mesh.  Each axis has one process group per line of the grid
(the ranks that differ only in that axis's coordinate), all created in
the same order on every rank, as ``torch.distributed.new_group`` demands.
It is written on plain process groups rather than
``torch.distributed.device_mesh.DeviceMesh``, which maps ranks to cards
by rank; here several ranks may share one card (gloo) and the CPU tests
run gloo worlds with no card at all.

Backends: ``gloo`` runs on the CPU and, staging CUDA tensors through host
memory, with several ranks on one card; ``nccl`` runs one rank per card.
The backend is always the caller's explicit choice: nothing switches to
another backend or to the CPU.

    results = run_world(fn, 4, backend="gloo", timeout=300.0, args=(cfg,))

runs ``fn(rank, world_size, *args)`` in 4 spawned processes that meet on
a ``FileStore`` in a temporary directory, and returns each rank's result.
``make_production_mesh`` (the reference's multi-host layout) is not ported.

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

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_local_mesh", "data_axes", "dp_size", "tp_size",
           "pmean", "run_world", "RankError"]

AXES = ("data", "model")


class Mesh:
    """A ``(data, model)`` grid over the ranks of the initialized world.

    ``shape`` maps axis name to size; ``coord(axis)`` is this rank's
    coordinate on an axis and ``group(axis)`` the process group of the
    ranks that share its other coordinate.  Building one calls
    ``torch.distributed.new_group`` for every line of both axes, so every
    rank of the world must build the same meshes in the same order."""

    def __init__(self, shape: Tuple[int, int], axis_names=AXES):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "Mesh needs an initialized torch.distributed world "
                "(torch.distributed.init_process_group, or run_world)")
        d, m = (int(n) for n in shape)
        world = dist.get_world_size()
        if d < 1 or m < 1 or d * m != world:
            raise ValueError(f"mesh shape {(d, m)} does not cover the "
                             f"world of {world} ranks")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (d, m)))
        self.rank = dist.get_rank()
        self._coords = dict(zip(self.axis_names, divmod(self.rank, m)))
        self._groups: Dict[str, Any] = {}
        # columns (the first axis varies), then rows (the second varies)
        for j in range(m):
            g = dist.new_group([i * m + j for i in range(d)])
            if self._coords[self.axis_names[1]] == j:
                self._groups[self.axis_names[0]] = g
        for i in range(d):
            g = dist.new_group([i * m + j for j in range(m)])
            if self._coords[self.axis_names[0]] == i:
                self._groups[self.axis_names[1]] = g

    def coord(self, axis: str) -> int:
        return self._coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self._coords}, backend={dist.get_backend()})")


def make_local_mesh(model_axis: int = 1) -> Mesh:
    """A mesh over the whole world: ``(world // model_axis, model_axis)``."""
    n = dist.get_world_size()
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


def pmean(mesh: Mesh, axis: str, loss: torch.Tensor,
          grads: Dict[str, torch.Tensor]):
    """``(loss, grads)`` averaged over ``axis``'s group in one all-reduce, so
    that every rank of the group applies the same update."""
    n = mesh.shape[axis]
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

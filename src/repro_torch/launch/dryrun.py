"""Multi-node dry run on ``device="meta"``: the counterpart of the
reference package's ``launch/dryrun.py`` (``lower_cell``, ``run_cell``,
the same command line and the same JSON record).

For every (architecture x input-shape) cell this builds ONE rank's shards
of the parameters (and the AdamW state, or its ZeRO-1 layout under
``REPRO_ZERO1``) on ``meta`` from ``launch/sharding.param_specs`` on a
``launch/mesh.MeshShape`` of the production mesh, and runs the real
train, prefill or decode step on them (``backend="ref"``: the CUDA kernels
cannot run on ``meta``) with the rank's ``ParallelContext`` in ``record``
mode.  It records:

    * ``memory``: ``argument_bytes``, exact from the shard shapes (the
      parameters, the optimizer state, the batch or the cache), and
      ``temp_bytes``, the peak of the storage the step allocates, from a
      ``TorchDispatchMode`` that adds every new output storage's bytes
      when an op makes it and takes them off when the storage is freed
      (a weak reference to it): what autograd saves for the backward
      counts while it is held.  ``output_bytes`` is the step's outputs'.
    * ``cost``: ``flops``, counted by ``torch.utils.flop_counter.
      FlopCounterMode`` (matrix products and attention, every iteration of
      every loop: the layers, the flash chunks, the microbatches) for one
      rank;
    * ``collectives``: what the step ran (``ParallelContext.
      collective_summary``), per device.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results/dryrun

It is CPU work: no card is touched and nothing is allocated at the
model's size.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.launch import sharding
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import model as MD
from repro_torch.optim import adamw, warmup_cosine

PRODUCTION = {False: (16, 16), True: (2, 16, 16)}


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes held by storages that ops made while the mode
    was on (each storage once, however many views share it); the storages
    of ``existing`` (the step's arguments) are not counted."""

    def __init__(self, existing=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._old = {t.untyped_storage()._cdata
                     for t in torch.utils._pytree.tree_leaves(existing)
                     if isinstance(t, torch.Tensor)}
        self._seen = set()

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st._cdata
                if key not in self._seen and key not in self._old:
                    self._seen.add(key)
                    self.live += st.nbytes()
                    weakref.finalize(st, self._free, key, st.nbytes())
        self.peak = max(self.peak, self.live)
        return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def abstract_shards(cfg, mesh, ac) -> dict:
    """One rank's parameter shards on ``meta``."""
    dt = getattr(torch, cfg.param_dtype)

    def leaf(path, shape):
        spec = _get(ac.specs, path)
        return torch.empty(sharding.local_shape(shape, spec, mesh), dtype=dt,
                           device="meta")
    return sharding._tree_map(leaf, MD.param_shapes(cfg))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _opt_state(opt, params, mesh, zero1: bool):
    """AdamW's state on this rank: the moments shaped as the shards, or
    under ZeRO-1 each moment split over every mesh axis on its largest
    dim that divides (replicated parameters, sharded optimizer state)."""
    state = opt.init(MD.flatten(params))
    if not zero1:
        return state
    n = mesh.size

    def shard(t):
        shape = list(t.shape)
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % n == 0 and n > 1:
                shape[i] //= n
                break
        return torch.empty(shape, dtype=t.dtype, device="meta")
    mu = {k: shard(v) for k, v in state.mu.items()}
    return type(state)(state.step, mu, {k: shard(v) for k, v in state.nu.items()})


def lower_cell(arch: str, shape_name: str, mesh, cfg_overrides=None):
    """Returns ``(run, info)`` for one cell (``shape_name``: a name of
    ``shapes.SHAPES``, or a ``ShapeSpec``): ``run()`` runs the step once on
    this rank's meta shards and returns its outputs; ``info`` holds the
    config, the context and the arguments.  ``(None, reason)`` for a cell
    the shape set skips."""
    cfg = configs.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = (shape_name if isinstance(shape_name, SH.ShapeSpec)
             else SH.SHAPES[shape_name])
    reason = SH.skip_reason(cfg, shape)
    if reason:
        return None, reason
    ac = sharding.make_ac(mesh, cfg, mode="record")
    params = abstract_shards(cfg, mesh, ac)
    dp = tuple(mesh.axis_names) if cfg.pure_dp else None
    spec = sharding.batch_pspec((shape.global_batch,), mesh, 0, dp)
    rows = shape.global_batch // (ac.dp if spec[0] is not None else 1)
    info = {"cfg": cfg, "ac": ac, "shape": shape, "params": params}

    if shape.kind == "train":
        opt = adamw(warmup_cosine(3e-4, 100, 10000), weight_decay=0.1)
        ostate = _opt_state(opt, params, mesh,
                            zero1=bool(os.environ.get("REPRO_ZERO1")))
        batch = SH.input_specs(cfg, shape, rows)
        step = make_train_step(cfg, opt, ac, backend="ref")
        info["args"] = (params, ostate, batch)
        return (lambda: step(params, ostate, batch)), info

    if shape.kind == "prefill":
        batch = SH.input_specs(cfg, shape, rows)
        step = make_prefill_step(cfg, ac, backend="ref")
        info["args"] = (params, batch)
        return (lambda: step(params, batch)), info

    # decode
    ispec = SH.input_specs(cfg, shape, rows, ac)
    step = make_serve_step(cfg, ac)
    cparams = MD.compute_params(cfg, params)
    # a server holds the weights cast to the compute dtype once
    info["args"] = (cparams, ispec["cache"], ispec["tokens"], ispec["position"])
    return (lambda: step(cparams, ispec["cache"], ispec["tokens"],
                         ispec["position"])), info


def run_cell(arch: str, shape_name, multi_pod: bool,
             cfg_overrides=None, compute_roofline: bool = True,
             mesh_shape=None, rank: int = 0):
    t0 = time.time()
    mesh = MeshShape(mesh_shape or PRODUCTION[multi_pod], rank)
    run, info = lower_cell(arch, shape_name, mesh, cfg_overrides)
    if run is None:
        return {"arch": arch, "shape": getattr(shape_name, "name", shape_name),
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": info}
    t_lower = time.time() - t0
    flops = FlopCounterMode(display=False)
    live = LiveBytes(info["args"])
    with flops, live:
        out = run()
    t_run = time.time() - t0 - t_lower
    rec = {
        "arch": arch, "shape": getattr(shape_name, "name", shape_name),
        "mesh": "multi" if multi_pod else "single",
        "status": "ok",
        "n_devices": mesh.size,
        "mesh_shape": list(mesh.shape.values()),
        "lower_s": round(t_lower, 1), "run_s": round(t_run, 1),
        "memory": {
            "argument_bytes": _nbytes(info["args"]),
            "output_bytes": _nbytes(out),
            "temp_bytes": live.peak,
            "method": "LiveBytes: peak of the storages the step allocated "
                      "on meta (dispatch-mode tracker, weak references)",
        },
        "cost": {"flops": float(flops.get_total_flops())},
    }
    if compute_roofline:
        rec["collectives"] = info["ac"].collective_summary()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SH.SHAPES) + [None])
    ap.add_argument("--mesh", type=str, default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun")
    ap.add_argument("--moe-impl", type=str, default=None)
    ap.add_argument("--remat", type=str, default=None)
    ap.add_argument("--pure-dp", action="store_true")
    ap.add_argument("--param-dtype", type=str, default=None)
    ap.add_argument("--mesh-shape", type=str, default=None,
                    help="override logical mesh, e.g. 64,4")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (a quicker record; the report "
                         "scales nothing)")
    args = ap.parse_args(argv)

    archs = configs.ARCHS if (args.all or args.arch is None) else [args.arch]
    shps = list(SH.SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides = {}
    if args.remat:
        overrides["remat_policy"] = args.remat
    if args.pure_dp:
        overrides["pure_dp"] = True
    if args.param_dtype:
        overrides["param_dtype"] = args.param_dtype
    if args.grad_accum is not None:
        overrides["grad_accum"] = args.grad_accum
    if args.layers is not None:
        overrides["n_layers"] = args.layers

    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shps:
            for mp in meshes:
                tag = f"{configs.canonical(arch)}-{shape}-{'multi' if mp else 'single'}"
                out_path = os.path.join(args.out, tag + ".json")
                if os.path.exists(out_path):
                    print(f"[skip existing] {tag}")
                    continue
                try:
                    ov = dict(overrides)
                    if args.moe_impl:
                        cfg0 = configs.get(arch)
                        if cfg0.moe is not None:
                            ov["moe"] = dataclasses.replace(
                                cfg0.moe, impl=args.moe_impl)
                    ms = (tuple(int(x) for x in args.mesh_shape.split(","))
                          if args.mesh_shape else None)
                    rec = run_cell(arch, shape, mp, ov or None, mesh_shape=ms)
                except Exception as e:  # noqa: BLE001 — record the failure
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[{rec['status']:7s}] {tag} "
                      + (f"run={rec.get('run_s')}s" if rec["status"] == "ok"
                         else rec.get("reason", rec.get("error", ""))[:120]))


if __name__ == "__main__":
    main()

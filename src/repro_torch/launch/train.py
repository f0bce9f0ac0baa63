"""Training entry points, the counterparts of the reference package's
``launch/train.py``: the language model's training loop and command line
(``build``, ``train_loop``, ``main``) and the data-parallel
projector-in-the-loop CT step (``make_ct_dp_train_step``).

    # smoke-train an assigned arch (reduced config) on the host
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 30 --batch 8 --seq 128 --ckpt-dir /tmp/ck --device cpu

    # resume is automatic: re-running picks up from the latest checkpoint

    # two ranks of tensor parallelism (gloo, on the host)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 3 --device cpu --world 2 --model-axis 2

``train_loop`` runs on one device with ``mesh=None``, or on any
``(pod, data, model)`` mesh (``launch/mesh``): the ``model`` axis splits
the model (``launch/sharding``: tensor parallelism, and FSDP where the
config asks), the data axes split the batch (each rank draws its own rows;
the loss and gradients are averaged over the data axes only).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.projector import Projector
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     pmean, run_world)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as MD
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime import checkpoint as CKPT
from repro_torch.runtime import compression
from repro_torch.runtime.fault import Supervisor

__all__ = ["make_ct_dp_train_step", "build", "train_loop", "main"]

def make_ct_dp_train_step(spec, mesh, apply_fn: Callable, lr: float = 1e-3,
                          axis: str = "data",
                          device: Optional[Union[str, torch.device]] = None):
    """Data-parallel projector-in-the-loop CT train step on ``mesh``.

    ``apply_fn(params, y) -> volume(s)`` is the recon network; the loss is
    the projection-consistency term ``0.5 * mean (A x - y)^2`` with the
    differentiable forward projector inside the graph, so gradients flow
    through the matched pair.  Each rank runs the whole projector on its
    contiguous slice of the batch (classic data parallelism: the projector
    stays local; a ``DistributedProjector`` is for a *volume* that outgrows
    a device), then the gradients and the loss are averaged over ``axis``'s
    group.  Returns ``step(params, y) -> (params, loss)``: ``params`` a dict
    of tensors, replicated; ``y`` the global batch, the same on every rank;
    the SGD update ``p - lr * g``.  ``mesh=None`` runs the step on one
    device.  ``device=None`` means ``cuda``."""
    if getattr(spec, "shard", None) is not None:
        spec = spec.replace(shard=None)
    proj = Projector(spec, device)
    if mesh is not None:
        n, k = mesh.shape[axis], mesh.coord(axis)

    def step(params: Dict[str, torch.Tensor], y: torch.Tensor):
        if mesh is not None:
            if y.shape[0] % n:
                raise ValueError(f"batch={y.shape[0]} must divide over the "
                                 f"{n}-way {axis} axis")
            per = y.shape[0] // n
            y = y[k * per:(k + 1) * per]
        leaves = {name: p.detach().requires_grad_() for name, p in params.items()}
        loss = proj.data_consistency(apply_fn(leaves, y), y)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        loss = loss.detach()
        if mesh is not None:
            loss, grads = pmean(mesh, axis, loss, grads)
        return {name: p - lr * grads[name] for name, p in params.items()}, loss

    return step


def build(cfg, mesh, lr: float = 3e-4, total_steps: int = 10_000,
          compress: bool = False, ac=None):
    """The reference's optimizer and step: AdamW (weight decay 0.1) on a
    warmup-cosine schedule, warming up over ``min(100, total_steps // 10 +
    1)`` steps, and optionally 1-bit error-feedback compression of the
    gradients (its residual kept in the step's closure, started at zero;
    each leaf's scale its whole ``mean |x|`` over the ranks that split it).
    On a ``mesh`` the step takes the rank's shards (``ac``, default
    ``sharding.make_ac(mesh, cfg)``) and averages over the data axes.
    Returns ``(opt, step_fn)``."""
    opt = adamw(warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps),
                weight_decay=0.1)
    if mesh is not None and ac is None:
        ac = sharding.make_ac(mesh, cfg)
    compress_fn = None
    if compress:
        comp_state = {"res": None}
        leaf_sums = None if ac is None else ac.leaf_sums

        def compress_fn(grads):
            if comp_state["res"] is None:
                comp_state["res"] = compression.init_state(grads)
            q, comp_state["res"] = compression.compress(grads, comp_state["res"],
                                                        leaf_sums)
            return q

    step_fn = make_train_step(cfg, opt, ac, compress_fn=compress_fn)
    return opt, step_fn


def _relayout(fn, params, opt_state):
    """``fn`` (a model tree -> the same tree in another layout:
    ``sharding.gather_params`` or ``shard_params``) on the parameters and
    on the optimizer's moments (flat dicts)."""
    def flat(d):
        return MD.flatten(fn(MD.unflatten(d)))
    return fn(params), type(opt_state)(opt_state.step, flat(opt_state.mu),
                                       flat(opt_state.nu))


def _like(tree, template):
    """``tree`` (restored CPU tensors) with each leaf on its template
    leaf's device."""
    if isinstance(tree, dict):
        return {k: _like(v, template[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(template)(*(_like(a, b) for a, b in zip(tree, template)))
    return tree.to(template.device)


def train_loop(cfg, mesh, pipeline, steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 20, log_every: int = 5, seed: int = 0,
               fail_at_step: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None,
               lr: float = 3e-4, compress: bool = False):
    """Train ``cfg`` for ``steps`` steps on ``pipeline``'s batches; returns
    ``(params, losses)``, the losses of the steps this call ran.

    The parameters start from ``MD.init_params`` with a generator seeded
    with ``seed`` on ``device`` (None: the card); the optimizer and step
    are :func:`build`'s.  With ``ckpt_dir``, a checkpoint of the parameters,
    the optimizer state and the pipeline's state is written every
    ``ckpt_every`` steps and at the end (once: the reference writes the
    last step twice when ``ckpt_every`` divides ``steps``), and a call
    resumes from the latest one.  Step ``i`` trains on
    ``pipeline.batch(i)`` (by index, so a resumed run replays no batch),
    with zero ``vision_embeds`` for a VLM config, as the reference's loop.
    ``fail_at_step`` raises before that step (the fault-tolerance tests).

    ``mesh=None`` runs on one device.  On a mesh, every rank draws the full
    parameters from ``seed`` and keeps its shards (``sharding.
    shard_params``), so every mesh starts from the same weights.  Over data
    axes of n > 1 ranks each rank draws its own rows (``pipeline`` must be
    ``TokenPipeline(..., shard_index=<the rank's data coordinate, row-major
    over the data axes>, shard_count=n)``), and the loss and gradients are
    averaged over them.  A checkpoint holds the global layout
    (``sharding.gather_params`` of the parameters and of the optimizer's
    moments), written by rank 0, so a run resumes onto another mesh.  The
    schedule
    peaks at ``lr`` (``main``'s ``--lr``) and spans the run's ``steps``
    (:func:`build`'s ``total_steps``; the reference's loop parses ``--lr``,
    ignores it and always schedules 10,000 steps).  ``compress`` turns on
    :func:`build`'s 1-bit compression (its residual is not checkpointed)."""
    dev = resolve_device(device, "train_loop")
    ac = None if mesh is None else sharding.make_ac(mesh, cfg)
    opt, step_fn = build(cfg, mesh, lr=lr, total_steps=steps, compress=compress,
                         ac=ac)
    writer = mesh is None or mesh.rank == 0
    if ac is not None and ac.dp > 1:
        want = (ac.data_rank, ac.dp)
        got = (pipeline.shard_index, pipeline.shard_count)
        if got != want:
            raise ValueError(f"data-parallel rank at data coordinate {want[0]} "
                             f"of {want[1]} needs a pipeline with (shard_index, "
                             f"shard_count) = {want}, got {got}")
    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    start = 0
    if ckpt_dir and CKPT.latest_step(ckpt_dir) is not None:
        like = (params, opt.init(MD.flatten(params)))
        (p, o), extra, start = CKPT.restore(ckpt_dir, like)
        params, opt_state = _like(p, like[0]), _like(o, like[1])
        if ac is not None:
            params, opt_state = _relayout(lambda t: sharding.shard_params(
                cfg, t, mesh, specs=ac.specs), params, opt_state)
        pipeline.load_state_dict(extra["data"])
        print(f"[restore] resumed from step {start}")
    else:
        if ac is not None:
            params = sharding.shard_params(cfg, params, mesh, specs=ac.specs)
        opt_state = opt.init(MD.flatten(params))
    ckpt = CKPT.AsyncCheckpointer(ckpt_dir) if ckpt_dir and writer else None

    def save(step):
        # every rank takes part in the gathers; rank 0 writes
        state = (params, opt_state) if ac is None else _relayout(
            lambda t: sharding.gather_params(cfg, t, mesh, specs=ac.specs),
            params, opt_state)
        if ckpt:
            ckpt.save(step, state, {"data": pipeline.state_dict()})

    losses = []
    t0 = time.time()
    try:
        for i in range(start, steps):
            # Drive the pipeline by explicit step index: checkpointing an
            # iterator's internal counter would replay the wrong batch on
            # resume.
            toks = pipeline.batch(i)
            pipeline.step = i + 1
            if fail_at_step is not None and i == fail_at_step:
                raise RuntimeError("injected failure (fault-tolerance test)")
            batch = {"tokens": torch.from_numpy(toks).to(dev)}
            if cfg.vision_tokens:
                batch["vision_embeds"] = torch.zeros(
                    (toks.shape[0], cfg.vision_tokens, cfg.d_model),
                    dtype=getattr(torch, cfg.compute_dtype), device=dev)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if log_every and i % log_every == 0:
                print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                      f"({(time.time()-t0)/max(i-start+1,1):.2f}s/step)")
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                save(i + 1)
        if ckpt_dir and not (steps > start and steps % ckpt_every == 0):
            # the last step's state, unless the loop has just saved it
            save(steps)
    finally:
        if ckpt:
            # a save in flight lands before a failure propagates, so that
            # the restart finds it
            ckpt.wait()
    return params, losses


def _mesh(args):
    """``main``'s mesh: None on one process; else the launched world's
    (``torchrun``'s environment, or ``--world``'s spawned ranks), laid out
    by ``--production-mesh`` / ``--multi-pod`` or as ``(world //
    model_axis, model_axis)``."""
    production = args.production_mesh or args.multi_pod
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if args.device in (None, "cuda")
                                else "gloo")
    if production:
        return make_production_mesh(multi_pod=args.multi_pod)
    if not dist.is_initialized():
        if args.model_axis > 1:
            raise ValueError(f"--model-axis {args.model_axis} needs a world of "
                             f"ranks: --world N, or a torchrun launch")
        return None
    return make_local_mesh(args.model_axis)


def _train(args):
    """``main``'s run on this process (one rank of a world, or alone)."""
    mesh = _mesh(args)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    shard = {}
    if mesh is not None:
        ac = sharding.make_ac(mesh, cfg)
        shard = {"shard_index": ac.data_rank, "shard_count": ac.dp}
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, **shard)
    if cfg.n_codebooks > 1:
        # the reference's stub: every codebook gets the same tokens
        base = pipe.batch
        pipe.batch = lambda step=None: np.stack(
            [base(step)] * cfg.n_codebooks, axis=1)
    attempts = {"n": 0}
    out = {}

    def loop(start):
        attempts["n"] += 1
        # inject the failure only on the first attempt (simulated node loss)
        fail = args.fail_at if attempts["n"] == 1 else None
        out["params"], out["losses"] = train_loop(
            cfg, mesh, pipe, args.steps, args.ckpt_dir,
            ckpt_every=args.ckpt_every, fail_at_step=fail, device=args.device,
            lr=args.lr)
        return args.steps

    def restore():
        if args.ckpt_dir:
            return CKPT.latest_step(args.ckpt_dir) or 0
        return 0

    Supervisor(loop, restore, max_restarts=args.max_restarts).run()
    return out.get("losses")


def _world_rank(rank, world, args):
    return _train(args)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train an assigned architecture under the "
                    "Supervisor, with checkpoints and automatic resume.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (host-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh over the launched world")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) mesh over the launched world")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel ranks (a (world // n, n) mesh)")
    ap.add_argument("--world", type=int, default=None,
                    help="spawn this many gloo ranks on this host (without "
                         "it: torchrun's world, or one process)")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cpu' trains on the host; the default is the card")
    args = ap.parse_args(argv)
    if args.world:
        losses = run_world(_world_rank, args.world, backend="gloo",
                           timeout=3600.0, args=(args,))[0]
    else:
        losses = _train(args)
    print("done.")
    return losses


if __name__ == "__main__":
    main()

"""Training entry points, the counterparts of the reference package's
``launch/train.py``: the language model's training loop and command line
(``build``, ``train_loop``, ``main``) and the data-parallel
projector-in-the-loop CT step (``make_ct_dp_train_step``).

    # smoke-train an assigned arch (reduced config) on the host
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 30 --batch 8 --seq 128 --ckpt-dir /tmp/ck --device cpu

    # resume is automatic: re-running picks up from the latest checkpoint

``train_loop`` runs one model replica a rank: on one device with
``mesh=None``, or data-parallel over a mesh's ``data`` axis (each rank
draws its own rows, the loss and gradients averaged in one all-reduce).
A ``model`` axis larger than 1 (tensor parallelism, the reference's
``launch/sharding.py``) and the reference's production meshes are not
ported.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.projector import Projector
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import dp_size, pmean, tp_size
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as MD
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime import checkpoint as CKPT
from repro_torch.runtime import compression
from repro_torch.runtime.fault import Supervisor

__all__ = ["make_ct_dp_train_step", "build", "train_loop", "main"]

UNPORTED_MESH = ("is not ported: tensor parallelism and the production "
                 "meshes need launch/sharding.py and "
                 "launch/mesh.py::make_production_mesh (ROADMAP.md queue 1 "
                 "item 5)")


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


def _reduce_fn(mesh):
    """The data-parallel mean of (loss, grads) over ``mesh``'s ``data``
    axis; None on one rank (no all-reduce, and no flat copy of the
    gradients)."""
    if mesh is None:
        return None
    if tp_size(mesh) > 1:
        raise NotImplementedError(f"a model axis of {tp_size(mesh)} "
                                  f"{UNPORTED_MESH}")
    if dp_size(mesh) == 1:
        return None
    return lambda loss, grads: pmean(mesh, "data", loss, grads)


def build(cfg, mesh, lr: float = 3e-4, total_steps: int = 10_000,
          compress: bool = False):
    """The reference's optimizer and step: AdamW (weight decay 0.1) on a
    warmup-cosine schedule, warming up over ``min(100, total_steps // 10 +
    1)`` steps, and optionally 1-bit error-feedback compression of the
    gradients (its residual kept in the step's closure, started at zero).
    Returns ``(opt, step_fn)``."""
    opt = adamw(warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps),
                weight_decay=0.1)
    compress_fn = None
    if compress:
        comp_state = {"res": None}

        def compress_fn(grads):
            if comp_state["res"] is None:
                comp_state["res"] = compression.init_state(grads)
            q, comp_state["res"] = compression.compress(grads, comp_state["res"])
            return q

    step_fn = make_train_step(cfg, opt, compress_fn=compress_fn,
                              reduce_fn=_reduce_fn(mesh))
    return opt, step_fn


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
               lr: float = 3e-4):
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

    ``mesh=None`` runs on one device.  Over a mesh with a ``data`` axis of
    n > 1 ranks, every rank starts from the same parameters, draws its own
    rows (``pipeline`` must be ``TokenPipeline(..., shard_index=<the rank's
    data coordinate>, shard_count=n)``), and the loss and gradients are
    averaged over the axis; rank 0 writes the checkpoints.  The schedule
    peaks at ``lr`` (``main``'s ``--lr``) and spans the run's ``steps``
    (:func:`build`'s ``total_steps``; the reference's loop parses ``--lr``,
    ignores it and always schedules 10,000 steps)."""
    dev = resolve_device(device, "train_loop")
    opt, step_fn = build(cfg, mesh, lr=lr, total_steps=steps)
    writer = mesh is None or mesh.rank == 0
    if mesh is not None and dp_size(mesh) > 1:
        want = (mesh.coord("data"), dp_size(mesh))
        got = (pipeline.shard_index, pipeline.shard_count)
        if got != want:
            raise ValueError(f"data-parallel rank at data coordinate {want[0]} "
                             f"of {want[1]} needs a pipeline with (shard_index, "
                             f"shard_count) = {want}, got {got}")
    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    opt_state = opt.init(MD.flatten(params))

    start = 0
    ckpt = CKPT.AsyncCheckpointer(ckpt_dir) if ckpt_dir and writer else None
    if ckpt_dir and CKPT.latest_step(ckpt_dir) is not None:
        (p, o), extra, start = CKPT.restore(ckpt_dir, (params, opt_state))
        params, opt_state = _like(p, params), _like(o, opt_state)
        pipeline.load_state_dict(extra["data"])
        print(f"[restore] resumed from step {start}")

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
            if ckpt and (i + 1) % ckpt_every == 0:
                ckpt.save(i + 1, (params, opt_state),
                          {"data": pipeline.state_dict()})
        if ckpt and not (steps > start and steps % ckpt_every == 0):
            # the last step's state, unless the loop has just saved it
            ckpt.save(steps, (params, opt_state),
                      {"data": pipeline.state_dict()})
    finally:
        if ckpt:
            # a save in flight lands before a failure propagates, so that
            # the restart finds it
            ckpt.wait()
    return params, losses


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
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cpu' trains on the host; the default is the card")
    args = ap.parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise NotImplementedError(f"--production-mesh / --multi-pod "
                                  f"{UNPORTED_MESH}")

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch)
    if cfg.n_codebooks > 1:
        # the reference's stub: every codebook gets the same tokens
        base = pipe.batch
        pipe.batch = lambda step=None: np.stack(
            [base(step)] * cfg.n_codebooks, axis=1)
    attempts = {"n": 0}

    def loop(start):
        attempts["n"] += 1
        # inject the failure only on the first attempt (simulated node loss)
        fail = args.fail_at if attempts["n"] == 1 else None
        train_loop(cfg, None, pipe, args.steps, args.ckpt_dir,
                   ckpt_every=args.ckpt_every, fail_at_step=fail,
                   device=args.device, lr=args.lr)
        return args.steps

    def restore():
        if args.ckpt_dir:
            return CKPT.latest_step(args.ckpt_dir) or 0
        return 0

    Supervisor(loop, restore, max_restarts=args.max_restarts).run()
    print("done.")


if __name__ == "__main__":
    main()

"""Projector-in-the-loop CT training, the counterpart of the reference
package's ``launch/ct_train.py``.

It trains recon networks through the differentiable matched pair across
the three hard geometry classes:

  * ``limited_angle``  parallel beam, a contiguous missing angular wedge
                       (paper §4; the hybrid CT-Net + U-Net by default);
  * ``sparse_fan``     fan beam, randomly decimated views;
  * ``helical``        a helical modular-frame trajectory over a 3D volume,
                       sparse views along the helix.

One :class:`TrainConfig` (frozen, validated) describes a run; one
:class:`CTTrainer` executes it, on the card unless ``device="cpu"``:

    cfg = TrainConfig(geometry="sparse_fan", n=48, steps=300)
    trainer = CTTrainer(cfg)
    losses = trainer.fit()             # auto-resumes from cfg.ckpt_dir
    metrics = trainer.evaluate()       # PSNR/SSIM + DC residual, EMA params

Training loss = supervised reconstruction MSE + the masked
data-consistency term through the matched pair (+ a sinogram-completion
term for the hybrid model).  On a CUDA device every projection of a step
(the data synthesis, the data-consistency term and its backward, the
helical initial reconstruction) runs the port's CUDA kernels; the
networks are ``F.conv2d``, group norm and SiLU, and the hybrid model's FBP
is plain torch, all differentiated by autograd.

The parameters, the optimizer state and the EMA are flat dicts of tensors
keyed as the networks' state dicts; the networks themselves are called
with ``torch.func.functional_call``, so evaluation can run any of them.

CLI (the training-smoke gate of docs/TRAINING.md)::

    PYTHONPATH=src python -m repro_torch.launch.ct_train \
        --geometry all --smoke --check --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from repro_torch.core.geometry import (CTGeometry, VolumeGeometry, fan_beam,
                                       helical_beam, parallel_beam)
from repro_torch.core.projector import Projector
from repro_torch.core.spec import ProjectorSpec
from repro_torch.data.metrics import psnr, ssim
from repro_torch.data.pipeline import CTDataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import dp_size, make_local_mesh, pmean
from repro_torch.nn import CTNet, UNet
from repro_torch.optim import (AdamWState, EmaState, adamw, apply_updates,
                               ema_init, ema_params, ema_update,
                               warmup_cosine)
from repro_torch.recon.completion import (complete_and_refine,
                                          projection_residual)
from repro_torch.runtime import checkpoint as CKPT

__all__ = ["GEOMETRIES", "TrainConfig", "CTTrainer", "build_geometry",
           "smoke_config", "main"]

GEOMETRIES = ("limited_angle", "sparse_fan", "helical")
_MODELS = ("auto", "unet", "hybrid")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Frozen description of one projector-in-the-loop training run (the
    reference's fields, defaults and checks).

    Geometry/data:
        geometry:      one of :data:`GEOMETRIES`.
        n:             transaxial volume size (``n x n`` voxels).
        nz:            axial size; 0 = auto (8 for helical, 1 otherwise).
        available_deg: angular coverage for ``limited_angle`` masks.
        n_views_few:   measured views for the sparse modes; 0 = auto
                       (half of the geometry's views).
    Model:
        model:         "auto" | "unet" | "hybrid".  "auto" picks the hybrid
                       CT-Net + U-Net for ``limited_angle`` and the
                       image-domain U-Net elsewhere; "hybrid" needs a 2D
                       (single detector row) geometry.
        base/levels:   U-Net width/depth;  ``depth`` is the CT-Net depth.
    Optimization:
        steps/batch/lr/warmup: AdamW + warmup-cosine.
        dc_weight:     weight of the masked data-consistency loss through
                       the projector (0 disables).
        sino_weight:   weight of the sinogram-completion loss (hybrid only).
        ema_decay/ema_warmup: evaluation-parameter averaging.
    Infrastructure:
        compute_dtype: kernel tile precision for the in-loop projector
                       ("bfloat16" | "float32" | None = follow input).
        data_parallel: in a ``torch.distributed`` world of more than one
                       rank, each rank takes its contiguous slice of every
                       batch and the gradients and loss are averaged over
                       the ranks before the update; one rank runs
                       unsharded.
        ckpt_dir/ckpt_every: checkpoint location and cadence (None = off).
        refine_iters/refine_beta: CG data-consistency refinement used by
                       :meth:`CTTrainer.evaluate`.
    """

    geometry: str = "limited_angle"
    n: int = 48
    nz: int = 0
    available_deg: float = 60.0
    n_views_few: int = 0
    model: str = "auto"
    base: int = 16
    levels: int = 2
    depth: int = 3
    steps: int = 120
    batch: int = 4
    lr: float = 2e-3
    warmup: int = 20
    dc_weight: float = 0.1
    sino_weight: float = 0.5
    ema_decay: float = 0.999
    ema_warmup: int = 10
    compute_dtype: Optional[str] = None
    data_parallel: bool = False
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    refine_iters: int = 20
    refine_beta: float = 0.05
    seed: int = 0

    def __post_init__(self):
        if self.geometry not in GEOMETRIES:
            raise ValueError(f"unknown geometry {self.geometry!r}; expected "
                             f"one of {GEOMETRIES}")
        if self.model not in _MODELS:
            raise ValueError(f"unknown model {self.model!r}; expected one "
                             f"of {_MODELS}")
        if self.n < 8:
            raise ValueError(f"n must be >= 8, got {self.n}")
        if self.nz == 0:
            object.__setattr__(self, "nz",
                               8 if self.geometry == "helical" else 1)
        if self.nz < 1:
            raise ValueError(f"nz must be >= 1 (or 0 = auto), got {self.nz}")
        if self.geometry == "helical" and self.nz < 2:
            raise ValueError("helical training needs a volumetric object "
                             f"(nz >= 2), got nz={self.nz}")
        if self.steps < 1 or self.batch < 1:
            raise ValueError(f"steps/batch must be >= 1, got "
                             f"{(self.steps, self.batch)}")
        if self.resolved_model == "hybrid" and self.geometry == "helical":
            raise ValueError("the hybrid CT-Net path operates on 2D "
                             "(single-row) sinograms; helical geometries "
                             "need model='unet'")
        if not 0.0 <= self.dc_weight:
            raise ValueError(f"dc_weight must be >= 0, got {self.dc_weight}")

    @property
    def resolved_model(self) -> str:
        if self.model != "auto":
            return self.model
        return "hybrid" if self.geometry == "limited_angle" else "unet"

    @property
    def mask_mode(self) -> str:
        return ("limited_angle" if self.geometry == "limited_angle"
                else "few_view")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def build_geometry(cfg: TrainConfig) -> CTGeometry:
    """The scanner for a config: one representative hard geometry per class,
    sized relative to ``cfg.n`` so every knob scales together."""
    n = cfg.n
    if cfg.geometry == "limited_angle":
        vol = VolumeGeometry(n, n, 1)
        return parallel_beam(int(1.5 * n), 1, int(1.5 * n), vol)
    if cfg.geometry == "sparse_fan":
        vol = VolumeGeometry(n, n, 1)
        return fan_beam(int(1.5 * n), 1, int(2.2 * n), vol,
                        sod=2.0 * n, sdd=3.0 * n, angular_range=360.0)
    # helical: 2 turns covering the volume's z extent, detector rows wide
    # enough (at magnification 1.5) to see the whole pitch per view.
    vol = VolumeGeometry(n, n, cfg.nz)
    return helical_beam(n_turns=2.0, pitch=cfg.nz / 2.0,
                        n_angles=int(1.5 * n), n_rows=max(6, cfg.nz // 2 + 2),
                        n_cols=int(2.2 * n), vol=vol,
                        sod=2.0 * n, sdd=3.0 * n, pixel_height=2.0)


def smoke_config(geometry: str, **overrides) -> TrainConfig:
    """Tiny config (~40 steps) of the training-smoke gate."""
    base = dict(geometry=geometry, n=32, steps=40, batch=4, base=8,
                levels=2, depth=2, lr=2e-3, warmup=5, ema_warmup=5,
                refine_iters=15)
    if geometry == "helical":
        base.update(n=20, nz=4, batch=2)
    base.update(overrides)
    return TrainConfig(**base)


def _sub(params: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


class CTTrainer:
    """Projector-in-the-loop trainer: ``fit`` / ``evaluate`` / ``resume``.

    ``device=None`` means ``cuda`` and raises without it; ``device="cpu"``
    runs on the host.  With ``cfg.data_parallel`` in a world of more than
    one rank, every rank builds its trainer (the mesh's process groups are
    made collectively) and every step is a collective."""

    def __init__(self, cfg: TrainConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device, "CTTrainer")
        self._mesh = None
        if (cfg.data_parallel and dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            self._mesh = make_local_mesh()
            if cfg.batch % dp_size(self._mesh):
                raise ValueError(
                    f"batch={cfg.batch} must divide over the "
                    f"{dp_size(self._mesh)}-way data axis")
        # each rank draws its contiguous slice of every global batch
        shards = ({} if self._mesh is None else
                  {"shard_index": self._mesh.coord("data"),
                   "shard_count": dp_size(self._mesh)})
        self.geom = build_geometry(cfg)
        self.proj = Projector(ProjectorSpec(self.geom,
                                            compute_dtype=cfg.compute_dtype),
                              self.device)
        n_few = cfg.n_views_few or max(8, self.geom.n_angles // 2)
        self.pipe = CTDataPipeline(self.geom, batch_size=cfg.batch,
                                   seed=cfg.seed, mode=cfg.mask_mode,
                                   available_deg=cfg.available_deg,
                                   n_views_few=n_few, **shards)
        self.params = self._init_params(
            torch.Generator().manual_seed(cfg.seed))
        self.opt = adamw(warmup_cosine(cfg.lr, cfg.warmup, cfg.steps))
        self.opt_state = self.opt.init(self.params)
        self.ema = ema_init(self.params)
        self.step = 0

    # -- model ------------------------------------------------------------- #
    def _init_params(self, generator: torch.Generator) -> dict:
        """Builds the networks (drawn on the host from ``generator``, so the
        card and the host start from the same weights) and returns their
        parameters on the trainer's device, keyed ``"<net>.<name>"``."""
        cfg = self.cfg
        nets = {"unet": UNet(base=cfg.base, levels=cfg.levels, in_ch=cfg.nz,
                             out_ch=cfg.nz, generator=generator)}
        if cfg.resolved_model == "hybrid":
            nets["ctnet"] = CTNet(base=cfg.base, depth=cfg.depth,
                                  generator=generator)
        self.nets = nn.ModuleDict(nets)
        return {k: v.detach().to(self.device, copy=True)
                for k, v in self.nets.state_dict().items()}

    def _unet(self, params: dict, vol: torch.Tensor) -> torch.Tensor:
        """The U-Net on volumes: (B, nx, ny, nz) <-> its (B, nz, nx, ny)."""
        x = vol.permute(0, 3, 1, 2).contiguous()
        y = functional_call(self.nets["unet"], _sub(params, "unet"), (x,))
        return y.permute(0, 2, 3, 1).contiguous()

    def _initial_recon(self, sino_masked, mask):
        """Network input from the ill-posed data: masked FBP where an
        analytic inverse exists (parallel/fan), mask-normalized
        backprojection for modular/helical frames."""
        m4 = mask[:, :, None, None]
        if self.geom.geom_type in ("parallel", "fan"):
            return self.proj.fbp(sino_masked * m4)
        # SIRT-style normalization A^T(M y) / A^T(M A 1): the denominator
        # carries the ray path lengths, so x0 lands at attenuation scale.
        fp_ones = self.proj(torch.ones(self.geom.vol.shape,
                                       dtype=sino_masked.dtype,
                                       device=sino_masked.device))
        norm = self.proj.T(m4 * fp_ones[None])
        x0 = self.proj.T(m4 * sino_masked)
        floor = 1e-3 * torch.amax(norm, dim=(1, 2, 3), keepdim=True) + 1e-12
        return x0 / torch.maximum(norm, floor)

    def predict(self, params: dict, sino_masked, mask):
        """(B, na, nv, nu) masked sinogram + (B, na) view mask ->
        ``(volume (B, nx, ny, nz), completed sinogram or None)``.  The
        hybrid model's FBP keeps the gradient, so CT-Net trains end to
        end."""
        if self.cfg.resolved_model == "hybrid":
            mask2d = mask[:, :, None] * torch.ones(
                (1, 1, self.geom.n_cols), dtype=sino_masked.dtype,
                device=sino_masked.device)
            completed = functional_call(self.nets["ctnet"],
                                        _sub(params, "ctnet"),
                                        (sino_masked[:, :, 0, :], mask2d))
            x_in = self.proj.fbp(completed[:, :, None, :])
            return self._unet(params, x_in), completed[:, :, None, :]
        x_in = self._initial_recon(sino_masked, mask)
        return self._unet(params, x_in), None

    # -- loss / step ------------------------------------------------------- #
    def loss_fn(self, params: dict, sino, mask, gt_vol) -> torch.Tensor:
        """Supervised MSE + masked data-consistency through the matched
        pair (+ completion loss for the hybrid model)."""
        cfg = self.cfg
        m4 = mask[:, :, None, None]
        pred, completed = self.predict(params, sino * m4, mask)
        loss = torch.mean(torch.square(pred - gt_vol))
        if cfg.dc_weight:
            dc = torch.mean(torch.square((self.proj(pred) - sino) * m4))
            loss = loss + cfg.dc_weight * dc
        if completed is not None:
            loss = loss + cfg.sino_weight * torch.mean(
                torch.square(completed - sino))
        return loss

    def grad_fn(self, params: dict, sino, mask, gt_vol):
        """(loss, gradients keyed as ``params``)."""
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = self.loss_fn(leaves, sino, mask, gt_vol)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def train_step(self, sino, mask, gt_vol) -> torch.Tensor:
        """One AdamW step and EMA update; returns the loss (on the device)."""
        loss, grads = self.grad_fn(self.params, sino, mask, gt_vol)
        if self._mesh is not None:
            loss, grads = pmean(self._mesh, "data", loss, grads)
        updates, self.opt_state = self.opt.update(grads, self.opt_state,
                                                  self.params)
        self.params = apply_updates(self.params, updates)
        self.ema = ema_update(self.ema, self.params,
                              decay=self.cfg.ema_decay,
                              warmup=self.cfg.ema_warmup)
        return loss

    def data(self, step: int):
        """Batch ``step`` on the device: (sinogram, mask, volume); under data
        parallelism this rank's contiguous slice of it."""
        imgs, masks = self.pipe.batch(step)
        gt_vol = self._as_volume(imgs)
        with torch.no_grad():
            sino = self.proj(gt_vol)
        return sino, torch.from_numpy(masks).to(self.device), gt_vol

    def _as_volume(self, imgs) -> torch.Tensor:
        a = torch.from_numpy(np.asarray(imgs)).to(self.device)
        return a if a.ndim == 4 else a[..., None]

    # -- state ------------------------------------------------------------- #
    def state_dict(self) -> dict:
        """Parameters, optimizer state and EMA (the checkpoint's leaves)."""
        return {"params": self.params, "opt": self.opt_state, "ema": self.ema}

    def load_state_dict(self, state: dict) -> None:
        def dev(d, like):
            return {k: v.to(self.device, like[k].dtype) for k, v in d.items()}

        opt, ema = state["opt"], state["ema"]
        self.params = dev(state["params"], self.params)
        self.opt_state = AdamWState(step=opt.step.to(torch.int32),
                                    mu=dev(opt.mu, self.opt_state.mu),
                                    nu=dev(opt.nu, self.opt_state.nu))
        self.ema = EmaState(step=ema.step.to(torch.int32),
                            params=dev(ema.params, self.ema.params))

    # -- public API -------------------------------------------------------- #
    def resume(self) -> int:
        """Restore params/opt/EMA + the data-pipeline cursor from the latest
        checkpoint under ``cfg.ckpt_dir``.  Returns the restored step (0
        when there is nothing to restore)."""
        cfg = self.cfg
        if not cfg.ckpt_dir or CKPT.latest_step(cfg.ckpt_dir) is None:
            return 0
        state, extra, self.step = CKPT.restore(cfg.ckpt_dir,
                                               self.state_dict())
        self.load_state_dict(state)
        self.pipe.load_state_dict(extra["data"])
        return self.step

    def fit(self, log_every: int = 20, on_step=None) -> list:
        """Run the configured schedule (auto-resuming first); returns the
        per-step loss list.  ``on_step(i, loss)`` is an optional callback."""
        cfg = self.cfg
        start = self.resume()
        # under data parallelism every rank holds the same state: rank 0
        # writes it
        writer = self._mesh is None or dist.get_rank() == 0
        ckpt = (CKPT.AsyncCheckpointer(cfg.ckpt_dir)
                if cfg.ckpt_dir and writer else None)
        losses = []
        t0 = time.time()
        try:
            for i in range(start, cfg.steps):
                loss = float(self.train_step(*self.data(i)))
                losses.append(loss)
                self.step = i + 1
                if on_step is not None:
                    on_step(i, loss)
                if log_every and i % log_every == 0:
                    print(f"[{cfg.geometry}] step {i:4d}  loss {loss:.6f}  "
                          f"({(time.time() - t0) / max(i - start + 1, 1):.2f}"
                          f"s/step)")
                if ckpt and self.step % cfg.ckpt_every == 0:
                    ckpt.save(self.step, self.state_dict(),
                              {"data": self.pipe.state_dict()})
            if ckpt:
                ckpt.save(self.step, self.state_dict(),
                          {"data": self.pipe.state_dict()})
        finally:
            # a step that raises still leaves the last save complete
            if ckpt:
                ckpt.wait()
        return losses

    @torch.no_grad()
    def evaluate(self, n_test: int = 4, use_ema: bool = True,
                 params: Optional[dict] = None) -> dict:
        """Held-out phantoms through the paper-§4 inference pipeline
        (network prediction, then CG data-consistency refinement); means
        over ``n_test`` of ``psnr_net``/``ssim_net``,
        ``psnr_refined``/``ssim_refined`` and the relative projection
        residuals ``dc_net``/``dc_refined``.  The EMA parameters by
        default."""
        cfg = self.cfg
        if params is None:
            params = ema_params(self.ema) if use_ema else self.params
        acc = {k: 0.0 for k in ("psnr_net", "ssim_net", "psnr_refined",
                                "ssim_refined", "dc_net", "dc_refined")}
        for k in range(n_test):
            img, mask = self.pipe.sample(10_000 + k, 0)
            gt_vol = self._as_volume(img[None])[0]
            sino = self.proj(gt_vol)
            mask_t = torch.from_numpy(mask).to(self.device)
            m3 = mask_t[:, None, None]
            pred, _ = self.predict(params, (sino * m3)[None], mask_t[None])
            pred = pred[0]
            xr, _ = complete_and_refine(self.proj, pred, sino, m3,
                                        n_iters=cfg.refine_iters,
                                        beta=cfg.refine_beta)
            gt_np = gt_vol.cpu().numpy()
            pred_np, xr_np = pred.cpu().numpy(), xr.cpu().numpy()
            peak = float(gt_np.max())
            acc["psnr_net"] += psnr(pred_np, gt_np, peak)
            acc["ssim_net"] += ssim(pred_np, gt_np, peak)
            acc["psnr_refined"] += psnr(xr_np, gt_np, peak)
            acc["ssim_refined"] += ssim(xr_np, gt_np, peak)
            acc["dc_net"] += float(projection_residual(self.proj, pred,
                                                       sino, m3))
            acc["dc_refined"] += float(projection_residual(self.proj, xr,
                                                           sino, m3))
        return {k: v / n_test for k, v in acc.items()}


# --------------------------------------------------------------------------- #
# CLI: the training-smoke gate
# --------------------------------------------------------------------------- #
def _check_run(geometry: str, losses, metrics) -> list:
    """The training-smoke acceptance conditions; returns failure strings."""
    fails = []
    q = max(len(losses) // 4, 1)
    head, tail = float(np.mean(losses[:q])), float(np.mean(losses[-q:]))
    if not tail < head:
        fails.append(f"{geometry}: loss did not decrease "
                     f"(first-quarter mean {head:.6f} -> last-quarter "
                     f"mean {tail:.6f})")
    if not metrics["psnr_refined"] > metrics["psnr_net"]:
        fails.append(f"{geometry}: data-consistency refinement did not "
                     f"improve PSNR ({metrics['psnr_net']:.3f} dB -> "
                     f"{metrics['psnr_refined']:.3f} dB)")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--geometry", default="all",
                    choices=GEOMETRIES + ("all",))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config of the training-smoke gate")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--model", default=None, choices=_MODELS)
    ap.add_argument("--dc-weight", type=float, default=None)
    ap.add_argument("--compute-dtype", default=None)
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--n-test", type=int, default=4)
    ap.add_argument("--metrics-json", default=None,
                    help="write per-geometry losses+metrics as JSON")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless loss decreases and DC refinement "
                         "improves PSNR on held-out phantoms")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    overrides = {}
    for field, name in (("steps", "steps"), ("n", "size"),
                        ("batch", "batch"), ("model", "model"),
                        ("dc_weight", "dc_weight"),
                        ("compute_dtype", "compute_dtype")):
        v = getattr(args, name)
        if v is not None:
            overrides[field] = v
    if args.data_parallel:
        overrides["data_parallel"] = True

    geometries = GEOMETRIES if args.geometry == "all" else (args.geometry,)
    results, failures = {}, []
    for geometry in geometries:
        per_geom = dict(overrides)
        if args.ckpt_dir:
            per_geom["ckpt_dir"] = f"{args.ckpt_dir}/{geometry}"
        cfg = (smoke_config(geometry, **per_geom) if args.smoke
               else TrainConfig(geometry=geometry, **per_geom))
        print(f"=== {geometry}: {cfg.resolved_model} model, "
              f"{cfg.steps} steps, vol {build_geometry(cfg).vol.shape} ===")
        trainer = CTTrainer(cfg, device=args.device)
        t0 = time.time()
        losses = trainer.fit()
        train_s = time.time() - t0
        metrics = trainer.evaluate(n_test=args.n_test)
        print(f"    loss {losses[0]:.6f} -> {losses[-1]:.6f}   "
              f"net {metrics['psnr_net']:.3f} dB -> refined "
              f"{metrics['psnr_refined']:.3f} dB   "
              f"dc {metrics['dc_net']:.4f} -> {metrics['dc_refined']:.4f}")
        results[geometry] = {"config": dataclasses.asdict(cfg),
                             "device": str(trainer.device),
                             "losses": losses, "train_seconds": train_s,
                             "metrics": metrics}
        if args.check:
            failures.extend(_check_run(geometry, losses, metrics))

    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {args.metrics_json}")
    for f in failures:
        print(f"FAIL: {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Rank functions of the port's ``torch.distributed`` tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_dp_train.py``,
``tests/test_torch_lm_train.py``).

Each runs on every rank of a gloo world that
``repro_torch.launch.mesh.run_world`` starts on the CPU, does every check of
its world in one spawn, and returns plain numpy arrays, numbers and error
strings; the test process compares them with the reference package.  This
module imports no JAX, so the ranks start quickly.  The geometries are
built from the argument tuples in ``GEOMS``, which the tests also hand to
the reference package.
"""
import dataclasses
import warnings

import numpy as np
import torch

from repro_torch import Projector, ProjectorSpec, ShardSpec
import repro_torch.core.geometry as tgeo
from repro_torch.core.distributed import (DistributedProjector, distribute,
                                          halo_exchange_z, halo_reduce_z,
                                          make_distributed_projector)
from repro_torch.core.spec import reset_legacy_warnings
from repro_torch.launch.mesh import (Mesh, data_axes, dp_size,
                                     make_local_mesh, pmean, tp_size)
from repro_torch.recon import (cgls, complete_and_refine,
                               data_consistency_refine, fista_tv,
                               power_iteration, projection_residual, sirt)
from repro_torch.recon.result import as_projector

# name: (kind, (n_angles, n_rows, n_cols), volume, keyword arguments); the
# reference tests' geometries (tests/test_distributed_ct.py)
GEOMS = {
    "par_pair": ("parallel", (4, 4, 24), (16, 16, 4), {}),
    "par_legacy": ("parallel", (8, 4, 36), (24, 24, 4), {}),
    "par_sirt": ("parallel", (8, 4, 24), (16, 16, 4), {}),
    "cone_small": ("cone", (4, 4, 24), (16, 16, 4), dict(sod=60.0, sdd=80.0)),
    "par": ("parallel", (16, 8, 32), (24, 24, 8), {}),
    "cone": ("cone", (16, 8, 32), (24, 24, 8), dict(sod=60.0, sdd=80.0)),
    "helical": ("helical", (32, 6, 32), (24, 24, 32),
                dict(n_turns=4, pitch=8.0, sod=60.0, sdd=80.0)),
}


def make_geom(geo, name: str):
    """The geometry ``name`` in the package ``geo`` (the port's or the
    reference's ``core.geometry``)."""
    kind, (na, nv, nu), vshape, kw = GEOMS[name]
    vol = geo.VolumeGeometry(*vshape)
    if kind == "helical":
        return geo.helical_beam(n_angles=na, n_rows=nv, n_cols=nu, vol=vol,
                                **kw)
    ctor = {"parallel": geo.parallel_beam, "cone": geo.cone_beam}[kind]
    return ctor(na, nv, nu, vol, **kw)


def data(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _err(fn):
    """``(exception type name, message)`` of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:                      # noqa: BLE001 - returned to the test
        return type(e).__name__, str(e)
    return None


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dot_rel(dp, geom, seed=0) -> float:
    """Conditioning-aware adjointness error over the global tensors:
    ``|<Ax,y> - <x,A^T y>|`` over the term mass ``sum|Ax*y|``, every sum
    over every rank's pieces in float64."""
    x = _t(data(geom.vol.shape, seed))
    y = _t(data(geom.sino_shape, seed + 1))
    xs, ys = dp.shard_volume(x), dp.shard_sino(y)
    ax, aty = dp(xs).double(), dp.T(ys).double()
    lhs = dp.reduce_partial(torch.sum(ax * ys.double()), "sino")
    rhs = dp.reduce_partial(torch.sum(xs.double() * aty), "vol")
    mass = dp.reduce_partial(torch.sum(torch.abs(ax * ys.double())), "sino")
    return float(abs(lhs - rhs) / (mass + 1e-12))


def _pair(dp, geom, seed=0) -> dict:
    """The sharded FP and BP of seeded inputs, gathered to global tensors."""
    x = _t(data(geom.vol.shape, seed))
    y = _t(data(geom.sino_shape, seed + 1))
    return {"fp": _np(dp.gather_sino(dp(dp.shard_volume(x)))),
            "bp": _np(dp.gather_volume(dp.T(dp.shard_sino(y))))}


# --------------------------------------------------------------------------- #
# A world of one rank: a (1, 1) mesh
# --------------------------------------------------------------------------- #
def world_11(rank, world):
    mesh = Mesh((1, 1))
    out = {}
    g = make_geom(tgeo, "par_pair")
    dp = distribute(ProjectorSpec(g), mesh, z_axis="model", device="cpu")
    out["pair"] = _pair(dp, g)
    out["pair_dot"] = _dot_rel(dp, g)
    out["pair_repr"] = repr(dp)
    out["as_projector_passes"] = as_projector(dp) is dp

    # the legacy factory: the single-device pair, and one warning
    gl = make_geom(tgeo, "par_legacy")
    reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fp, bp, shard_v, shard_s = make_distributed_projector(
            gl, mesh, angle_axis="data", z_axis="model", device="cpu")
        make_distributed_projector(gl, mesh, device="cpu")
    out["legacy_warnings"] = [str(w.category.__name__) for w in caught]
    proj = Projector(ProjectorSpec(gl), "cpu")
    f, y = _t(data(gl.vol.shape, 0)), _t(data(gl.sino_shape, 1))
    out["legacy_fp"] = (_np(fp(shard_v(f))), _np(proj(f)))
    out["legacy_bp"] = (_np(bp(shard_s(y))), _np(proj.T(y)))
    out["legacy_cone_z"] = _err(lambda: make_distributed_projector(
        make_geom(tgeo, "cone_small"), mesh, z_axis="model", device="cpu"))

    # validation (tests/test_distributed_ct.py:172-194)
    gp = make_geom(tgeo, "par_pair")
    out["errors"] = {
        "not_a_spec": _err(lambda: DistributedProjector(gp, mesh, "cpu")),
        "no_shard": _err(lambda: DistributedProjector(ProjectorSpec(gp), mesh,
                                                      "cpu")),
        "mesh_axis": _err(lambda: DistributedProjector(ProjectorSpec(
            gp, shard=ShardSpec(("data", None), angle_shards=4)), mesh, "cpu")),
        "no_axis": _err(lambda: DistributedProjector(ProjectorSpec(
            gp, shard=ShardSpec(("rows", None))), mesh, "cpu")),
        "not_both": _err(lambda: distribute(ProjectorSpec(
            gp, shard=ShardSpec(("data", None))), mesh, z_axis="model",
            device="cpu")),
        "not_divisible": _err(lambda: distribute(ProjectorSpec(
            gp.subset(np.arange(3))), mesh, device="cpu", comm_blocks=2)),
        "cpu_tensor_on_cuda_default": _err(
            lambda: DistributedProjector(ProjectorSpec(
                gp, shard=ShardSpec(("data", None))), mesh)),
    }

    # SIRT and CGLS on the synchronous schedule: the same cached local ops,
    # bit for bit
    gq = make_geom(tgeo, "par_sirt")
    spec = ProjectorSpec(gq)
    dps = distribute(spec, mesh, comm="psum", device="cpu")
    f = torch.abs(_t(data(gq.vol.shape, 0)))
    y = Projector(spec, "cpu")(f)
    for name, solver, kw in (("sirt", sirt, {}), ("cgls", cgls, {"damp": 0.1})):
        a = solver(dps, y, n_iters=4, **kw)
        b = solver(spec, y, n_iters=4, **kw)
        out[f"{name}_bit_equal"] = (
            torch.equal(a.image, b.image)
            and torch.equal(a.residual_history, b.residual_history))
    out["dc"] = (float(dps.data_consistency(f, y + 0.1)),
                 float(Projector(spec, "cpu").data_consistency(f, y + 0.1)))
    # the other solvers: the same bits as on one device
    proj = Projector(spec, "cpu")
    mask = _t(half_views_mask(gq.sino_shape))
    out["solvers_bit_equal"] = {}
    for name, run in (
            ("fista_tv", lambda op: fista_tv(op, y, n_iters=3)),
            ("power_iteration", lambda op: power_iteration(op, n_iters=4)),
            ("data_consistency_refine", lambda op: data_consistency_refine(
                op, f, y, mask, n_iters=3)),
            ("complete_and_refine", lambda op: complete_and_refine(
                op, f, y, mask, n_iters=3)),
            ("projection_residual", lambda op: projection_residual(
                op, f, y, mask))):
        a, b = run(dps), run(proj)
        if hasattr(a, "image"):
            a, b = (a.image, a.residual_history), (b.image, b.residual_history)
        a, b = ((a,), (b,)) if torch.is_tensor(a) else (a, b)
        out["solvers_bit_equal"][name] = all(
            torch.equal(u, v) for u, v in zip(a, b))
    return out


def half_views_mask(sino_shape) -> np.ndarray:
    """Every other view measured: a few-view completion problem."""
    m = np.zeros(sino_shape, np.float32)
    m[::2] = 1.0
    return m


def solver_inputs(geom) -> dict:
    """The global inputs of the sharded solver checks: a nonnegative
    sinogram, a network prior and the half-views mask."""
    return {"y": np.abs(data(geom.sino_shape, 20)),
            "x_net": np.abs(data(geom.vol.shape, 21)),
            "mask": half_views_mask(geom.sino_shape)}


SOLVER_ITERS = dict(fista=4, fista_pi=3, power=10, dc=4, car=3)


def _sharded_solvers(dp, geom) -> dict:
    """FISTA-TV (L from the sharded power iteration, given; and with its own
    power iteration), data-consistency refinement, complete-and-refine and
    the projection residual on ``dp``, gathered to global tensors."""
    inp = {k: _t(v) for k, v in solver_inputs(geom).items()}
    ys, ms = dp.shard_sino(inp["y"]), dp.shard_sino(inp["mask"])
    xs = dp.shard_volume(inp["x_net"])
    it = SOLVER_ITERS
    L = float(power_iteration(dp, n_iters=it["power"])) * 1.05
    res = fista_tv(dp, ys, n_iters=it["fista"], L=L)
    res_pi = fista_tv(dp, ys, n_iters=it["fista_pi"])
    x_car, completed = complete_and_refine(dp, xs, ys, ms, n_iters=it["car"])
    return {"L": L,
            "fista": _np(dp.gather_volume(res.image)),
            "fista_hist": _np(res.residual_history),
            "fista_pi": _np(dp.gather_volume(res_pi.image)),
            "fista_pi_hist": _np(res_pi.residual_history),
            "dc": _np(dp.gather_volume(data_consistency_refine(
                dp, xs, ys, ms, n_iters=it["dc"]))),
            "car_x": _np(dp.gather_volume(x_car)),
            "car_sino": _np(dp.gather_sino(completed)),
            "residual": float(projection_residual(dp, xs, ys, ms))}


# --------------------------------------------------------------------------- #
# A world of four ranks: (2, 2) and (1, 4) meshes
# --------------------------------------------------------------------------- #
def world_4(rank, world, par_in):
    mesh22 = Mesh((2, 2))
    mesh14 = Mesh((1, 4))
    out = {"mesh": {
        "coords22": (mesh22.coord("data"), mesh22.coord("model")),
        "coords14": (mesh14.coord("data"), mesh14.coord("model")),
        "dp_tp22": (dp_size(mesh22), tp_size(mesh22)),
        "data_axes": data_axes(mesh22),
        "local": make_local_mesh(2).shape,
        "bad_shape": _err(lambda: Mesh((3, 1))),
    }}

    # halo exchange against the numpy oracle; reduce as its adjoint
    nz, halo = 16, 2
    k = mesh14.coord("model")
    f = _t(data((6, 6, nz), 0))
    ext = halo_exchange_z(f[..., k * 4:(k + 1) * 4], mesh14, "model", halo)
    parts = [torch.empty_like(ext) for _ in range(4)]
    torch.distributed.all_gather(parts, ext.contiguous())
    out["halo_exchange"] = _np(torch.cat(parts, dim=-1))
    x = _t(data((5, 5, nz), 1))[..., k * 4:(k + 1) * 4]
    yl = _t(data((5, 5, nz + 2 * halo * 4), 2))[..., k * 8:(k + 1) * 8]
    ex = halo_exchange_z(x, mesh14, "model", halo)
    etx = halo_reduce_z(yl, mesh14, "model", halo)
    sums = torch.stack([torch.sum(ex.double() * yl.double()),
                        torch.sum(x.double() * etx.double())])
    torch.distributed.all_reduce(sums)
    out["halo_adjoint"] = (float(sums[0]), float(sums[1]))

    # parallel (2, 2): against the reference's own sharded pair
    g = make_geom(tgeo, "par")
    dp = distribute(ProjectorSpec(g), mesh22, z_axis="model", device="cpu")
    ovl = distribute(ProjectorSpec(g), mesh22, z_axis="model", comm="overlap",
                     device="cpu")
    xp, yp = _t(par_in["x"]), _t(par_in["y"])
    out["par"] = {"halo": dp.shard.halo,
                  "fp": _np(dp.gather_sino(dp(dp.shard_volume(xp)))),
                  "bp": _np(dp.gather_volume(dp.T(dp.shard_sino(yp)))),
                  "dot": _dot_rel(dp, g),
                  "comm_blocks": len(ovl._layout.bp_specs),
                  "overlap": _np(ovl.gather_volume(ovl.T(ovl.shard_sino(yp))))}
    out["par"]["psum"] = out["par"]["bp"]
    out["par_solve"] = _sharded_solvers(dp, g)
    out["par_errors"] = {
        "halo_on_parallel": _err(lambda: distribute(
            ProjectorSpec(g), mesh22, z_axis="model", halo=1, device="cpu")),
    }

    # cone (2, 2): row blocks paired with halo-extended slabs
    g = make_geom(tgeo, "cone")
    dp = distribute(ProjectorSpec(g), mesh22, z_axis="model", device="cpu")
    out["cone"] = dict(_pair(dp, g), halo=dp.shard.halo, dot=_dot_rel(dp, g),
                       undersized=_err(lambda: distribute(
                           ProjectorSpec(g), mesh22, z_axis="model", halo=0,
                           device="cpu")))
    out["cone_solve"] = _sharded_solvers(dp, g)
    # the gradient of 0.5 ||Ax - y||^2 through the sharded pair, and double
    # backward
    xs = dp.shard_volume(_t(data(g.vol.shape, 3))).requires_grad_()
    ys = dp.shard_sino(_t(data(g.sino_shape, 4)))
    loss = 0.5 * dp.reduce_partial(torch.sum((dp(xs) - ys) ** 2), "sino")
    (grad,) = torch.autograd.grad(loss, xs, create_graph=True)
    want = dp.T(dp(xs.detach()) - ys)
    v = dp.shard_volume(_t(data(g.vol.shape, 5)))
    (hv,) = torch.autograd.grad(dp.reduce_partial(torch.sum(grad * v), "vol"),
                                xs)
    hv_want = dp.T(dp(v))
    grad = grad.detach()
    out["cone_grad"] = {
        "grad_max_err": float((grad - want).abs().max()),
        "grad_scale": float(want.abs().max()),
        "hv_max_err": float((hv - hv_want).abs().max()),
        "hv_scale": float(hv_want.abs().max())}

    # helical (1, 4): the sliding-z pipeline
    g = make_geom(tgeo, "helical")
    spec = ProjectorSpec(g)
    dp = distribute(spec, mesh14, z_axis="model", device="cpu")
    ovl = distribute(spec, mesh14, z_axis="model", comm="overlap", device="cpu")
    y = _t(data(g.sino_shape, 6))
    out["helical"] = dict(
        _pair(dp, g), halo=dp.shard.halo, dot=_dot_rel(dp, g),
        local_vol=dp.local_vol_shape(), comm_blocks=len(ovl._layout.bp_specs),
        overlap=_np(ovl.gather_volume(ovl.T(ovl.shard_sino(y)))),
        psum=_np(dp.gather_volume(dp.T(dp.shard_sino(y)))))
    fh = torch.abs(_t(data(g.vol.shape, 7)))
    yh = dp(dp.shard_volume(fh))
    res = sirt(dp, yh, n_iters=12)
    cg = cgls(dp, yh, n_iters=10)
    out["helical_solve"] = {
        "y": _np(dp.gather_sino(yh)),
        "sirt": _np(dp.gather_volume(res.image)),
        "sirt_hist": _np(res.residual_history),
        "cgls": _np(dp.gather_volume(cg.image)),
        "cgls_hist": _np(cg.residual_history)}
    return out if rank == 0 else {"mesh": out["mesh"],
                                  "cone_grad": out["cone_grad"],
                                  "helical_solve": {
                                      "sirt_hist": out["helical_solve"]["sirt_hist"]}}


# --------------------------------------------------------------------------- #
# Data-parallel training on two ranks
# --------------------------------------------------------------------------- #
DP_GEOM = ("parallel", (16, 8, 24), (16, 16, 8), {})   # test_distributed_ct.py:368


def dp_geom():
    kind, (na, nv, nu), vshape, _ = DP_GEOM
    return tgeo.parallel_beam(na, nv, nu, tgeo.VolumeGeometry(*vshape))


def dp_step_run(mesh, steps: int = 5, batch: int = 8):
    """``make_ct_dp_train_step`` from zero parameters on a batch of copies
    of one projection (tests/test_distributed_ct.py:364-387): the losses and
    the final parameters."""
    from repro_torch.launch.train import make_ct_dp_train_step
    g = dp_geom()
    spec = ProjectorSpec(g)

    def apply_fn(params, y):
        return params["vol"].expand((y.shape[0],) + g.vol.shape)

    step = make_ct_dp_train_step(spec, mesh, apply_fn, lr=5e-3, device="cpu")
    truth = torch.abs(_t(data(g.vol.shape, 0)))
    yb = Projector(spec, "cpu")(truth).expand((batch,) + g.sino_shape)
    params = {"vol": torch.zeros(g.vol.shape)}
    losses = []
    for _ in range(steps):
        params, loss = step(params, yb)
        losses.append(float(loss))
    return losses, _np(params["vol"])


def trainer_run(cfg_kw: dict):
    """``CTTrainer`` at ``smoke_config(**cfg_kw)`` on the CPU: the first
    batch's loss and gradients (averaged over the data axis under data
    parallelism), ``fit``'s losses and the final parameters."""
    from repro_torch.launch.ct_train import CTTrainer, smoke_config
    trainer = CTTrainer(smoke_config(**cfg_kw), "cpu")
    loss0, grads0 = trainer.grad_fn(trainer.params, *trainer.data(0))
    if trainer._mesh is not None:
        loss0, grads0 = pmean(trainer._mesh, "data", loss0, grads0)
    losses = trainer.fit(log_every=0)
    return {"loss0": float(loss0),
            "grads0": {k: _np(v) for k, v in grads0.items()},
            "losses": losses,
            "params": {k: _np(v) for k, v in trainer.params.items()}}


def world_dp(rank, world, cfg_kw: dict):
    mesh = make_local_mesh()
    out = {"step": dp_step_run(mesh),
           "trainer": trainer_run(dict(cfg_kw, data_parallel=True)),
           "indivisible": _err(lambda: trainer_run(
               dict(cfg_kw, data_parallel=True, batch=3)))}
    return out


def raise_on_rank_1(rank, world):
    if rank == 1:
        raise ArithmeticError("rank one fails on purpose")
    torch.distributed.barrier()
    return rank


# --------------------------------------------------------------------------- #
# Data-parallel LM training on two ranks
# --------------------------------------------------------------------------- #
LM_DP = dict(seq=64, batch=4, steps=3)


def lm_dp_cfg():
    """The Qwen3-0.6B smoke config in f32 (bf16 rounds the two runs'
    differently ordered sums to neighbouring values)."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                               compute_dtype="float32")


def lm_dp_run(mesh, pipe) -> dict:
    """The first batch's loss and gradients (averaged over the data axis
    under data parallelism) from ``train_loop``'s initial parameters, then
    ``train_loop``'s losses and final parameters."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as MD
    cfg = lm_dp_cfg()
    p0 = MD.init_params(cfg, torch.Generator().manual_seed(0))
    loss0, grads0 = value_and_grad(cfg, p0, {"tokens": torch.from_numpy(
        pipe.batch(0))})
    if mesh is not None:
        loss0, grads0 = pmean(mesh, "data", loss0, grads0)
    params, losses = train_loop(cfg, mesh, pipe, LM_DP["steps"], device="cpu",
                                log_every=0)
    return {"loss0": float(loss0),
            "grads0": {k: _np(v) for k, v in grads0.items()},
            "losses": losses,
            "params": {k: _np(v) for k, v in MD.flatten(params).items()}}


def world_lm_dp(rank, world):
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.train import train_loop
    cfg = lm_dp_cfg()
    mesh = make_local_mesh()
    pipe = TokenPipeline(cfg.vocab_size, LM_DP["seq"], LM_DP["batch"],
                         shard_index=mesh.coord("data"),
                         shard_count=dp_size(mesh))
    out = lm_dp_run(mesh, pipe)
    out["unsharded_pipeline"] = _err(lambda: train_loop(
        cfg, mesh, TokenPipeline(cfg.vocab_size, LM_DP["seq"], LM_DP["batch"]),
        1, device="cpu"))
    # a model axis of 2: tensor parallelism on the same two ranks
    out["model_axis"] = train_loop(
        cfg, Mesh((1, 2)), TokenPipeline(cfg.vocab_size, LM_DP["seq"],
                                         LM_DP["batch"]),
        LM_DP["steps"], device="cpu", log_every=0)[1]
    return out


# --------------------------------------------------------------------------- #
# Tensor, FSDP and TP x DP parallelism of the LM (launch/sharding.py)
# --------------------------------------------------------------------------- #
TP_BATCH = dict(B=4, S=16, seed=1)


def tp_cfg(arch: str, **change):
    """An arch's smoke config in f32 (the two layouts' differently ordered
    sums then agree to ~1e-7)."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(arch), compute_dtype="float32",
                               **change)


def tp_batch(cfg, B: int, S: int, seed: int) -> dict:
    """numpy: tokens (B, S) or (B, nq, S); a VLM's vision embeddings and
    M-RoPE positions whose three sections differ (``tests/
    test_torch_families.py``'s batch)."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks > 1 else (B, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)}
    if cfg.vision_tokens:
        nv = cfg.vision_tokens
        out["vision_embeds"] = (0.01 * rng.normal(size=(B, nv, cfg.d_model))).astype(np.float32)
        i = np.arange(nv)
        grid = np.stack([np.zeros(nv), i // 4, i % 4]).astype(np.int64)
        text = np.broadcast_to(np.arange(S) + grid.max() + 1, (3, S))
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.concatenate([grid, text], 1)[:, None], (3, B, nv + S)))
    return out


def _rows(batch: dict, idx: int, n: int) -> dict:
    """A data rank's rows of a batch (positions: rows on axis 1)."""
    out = {}
    for k, v in batch.items():
        axis = 1 if k == "positions" else 0
        per = v.shape[axis] // n
        out[k] = torch.from_numpy(np.take(v, range(idx * per, (idx + 1) * per),
                                          axis=axis))
    return out


def tp_loss_and_grads(cfg, mesh, fsdp=None, one=False) -> dict:
    """The loss and the gradients, gathered to the global layout, of one
    batch on ``mesh`` (averaged over its data axes), from ``init_params``'s
    weights of seed 0; with ``one``, also one device's on the whole batch
    and the weights (numpy)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model as MD
    full = MD.init_params(cfg, torch.Generator().manual_seed(0))
    ac = SH.make_ac(mesh, cfg, fsdp=fsdp)
    shards = SH.shard_params(cfg, full, mesh, specs=ac.specs)
    b = tp_batch(cfg, **TP_BATCH)
    loss, g = value_and_grad(cfg, shards, _rows(b, ac.data_rank, ac.dp), ac=ac)
    loss, g = ac.mean_grads(loss, g)
    g = MD.flatten(SH.gather_params(cfg, MD.unflatten(g), mesh, specs=ac.specs))
    out = {"loss": float(loss), "grads": {k: _np(v) for k, v in g.items()},
           "split": ac.split}
    if one:
        loss1, g1 = value_and_grad(cfg, full, _rows(b, 0, 1))
        out["one"] = {"loss": float(loss1),
                      "grads": {k: _np(v) for k, v in g1.items()}}
        out["params"] = {k: _np(v) for k, v in MD.flatten(full).items()}
    return out


def world_tp(rank, world, shape, cases, fsdp=None):
    """Every case of ``cases`` (name: (arch, config changes)) on a
    ``shape`` mesh (``make_production_mesh(shape=shape)``: three axes are
    ``("pod", "data", "model")``): rank 0 also runs one device."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(shape=shape)
    return {name: tp_loss_and_grads(tp_cfg(arch, **change), mesh, fsdp,
                                    one=rank == 0)
            for name, (arch, change) in cases.items()}


def world_tp_bf16(rank, world, archs):
    """Each of ``archs``' smoke configs in its own compute dtype (bf16) on a
    (1, world) mesh, so that the ``model`` collectives (under
    ``seq_shard``, the sequence's all-gathers and reduce-scatters) carry
    bf16 tensors; rank 0 also runs one device."""
    from repro_torch import configs
    mesh = Mesh((1, world))
    return {a: tp_loss_and_grads(configs.get_smoke(a), mesh, one=rank == 0)
            for a in archs}


TP_TRAIN = dict(seq=32, batch=4, steps=3, resumed=5)


class GlobalPipeline:
    """The global batch of ``n`` data ranks: each rank's rows
    (``TokenPipeline(shard_index=r, shard_count=n)``) in rank order, with a
    pipeline's state, so that one device trains on what the ranks do."""

    def __init__(self, cfg, n: int):
        from repro_torch.data.tokens import TokenPipeline
        self.parts = [TokenPipeline(cfg.vocab_size, TP_TRAIN["seq"],
                                    TP_TRAIN["batch"], shard_index=r,
                                    shard_count=n) for r in range(n)]
        self.step = 0
        self.shard_index, self.shard_count = 0, 1

    def batch(self, step):
        return np.concatenate([p.batch(step) for p in self.parts])

    def state_dict(self):
        return {"seed": self.parts[0].seed, "step": self.step}

    def load_state_dict(self, d):
        self.step = int(d["step"])


def tp_train_run(cfg, mesh, pipe, steps, **kw) -> dict:
    """``train_loop``'s losses and final parameters, gathered to the global
    layout on a mesh."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as MD
    params, losses = train_loop(cfg, mesh, pipe, steps, device="cpu",
                                log_every=0, **kw)
    if mesh is not None:
        params = SH.gather_params(cfg, params, mesh)
    return {"losses": losses,
            "params": {k: _np(v) for k, v in MD.flatten(params).items()}}


def tp_serve_run(cfg, mesh) -> dict:
    """A 4-slot ``Server`` on ``mesh`` (None: one device) answering four
    requests from ``init_params``'s weights of seed 0: the tokens."""
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import model as MD
    full = MD.init_params(cfg, torch.Generator().manual_seed(0))
    srv = Server(cfg, mesh, slots=4, max_len=32, device="cpu", params=full)
    rng = np.random.default_rng(3)
    for rid in range(5):
        srv.submit(Request(rid, rng.integers(0, cfg.vocab_size,
                                             size=rng.integers(3, 9)).tolist(), 8))
    return {r.rid: r.out for r in srv.run()}


def world_tp_train(rank, world, arch, ckpt_dir, serve_archs):
    """On a (2, 2) mesh: ``train_loop`` with compression (and clipping, as
    always); a ``train_loop`` of ``TP_TRAIN["resumed"]`` steps that writes a
    checkpoint at step 3 and fails there (``fail_at_step``); a Server of
    each of ``serve_archs`` whose slots split over the data axis."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding as SH
    cfg = tp_cfg(arch)
    mesh = Mesh((2, 2))
    ac = SH.make_ac(mesh, cfg)

    def pipe():
        return TokenPipeline(cfg.vocab_size, TP_TRAIN["seq"], TP_TRAIN["batch"],
                             shard_index=ac.data_rank, shard_count=ac.dp)
    return {"compressed": tp_train_run(cfg, mesh, pipe(), TP_TRAIN["steps"],
                                       compress=True),
            "failed": _err(lambda: tp_train_run(
                cfg, mesh, pipe(), TP_TRAIN["resumed"], ckpt_dir=ckpt_dir,
                ckpt_every=TP_TRAIN["steps"], fail_at_step=TP_TRAIN["steps"])),
            "serve": {a: tp_serve_run(tp_cfg(a), mesh) for a in serve_archs}}


def world_tp_resume(rank, world, arch, ckpt_dir):
    """The checkpoint of the (2, 2) run resumed on a (1, 1) mesh."""
    cfg = tp_cfg(arch)
    return tp_train_run(cfg, Mesh((1, 1)), GlobalPipeline(cfg, 2),
                        TP_TRAIN["resumed"], ckpt_dir=ckpt_dir,
                        ckpt_every=TP_TRAIN["steps"])


def world_tp_serve(rank, world, archs):
    """A Server of each arch on a (1, world) mesh; rank 0 also on one
    device."""
    mesh = Mesh((1, world))
    out = {}
    for a in archs:
        cfg = tp_cfg(a)
        out[a] = {"tp": tp_serve_run(cfg, mesh)}
        if rank == 0:
            out[a]["one"] = tp_serve_run(cfg, None)
    return out

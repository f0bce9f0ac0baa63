"""The port's CT training subsystem (``repro_torch.launch.ct_train``) against
the reference package's ``repro.launch.ct_train`` on the CPU, at the sizes
of ``tests/test_ct_train.py``'s ``tiny()`` (n = 12, base 8, one level) and
the helical smoke size (n = 20, nz = 4).

The reference trainer's initial parameters are carried into the port's
trainer by ``params_from_reference``; the same numpy batches go through
both.  Tolerances: one step's loss rtol 1e-5 and its gradients 1e-4 in
relative L2 (the two packages' projector pairs differ by ~1e-6); a 3-step
``fit``'s losses rtol 1e-4; ``evaluate``'s PSNRs within 0.05 dB (CG
amplifies the pairs' differences).  Also the reference's own checks:
config validation and auto fields, ``build_geometry`` parity, the
data-consistency term in the gradient, the full trainer-state checkpoint
round trip, and resume (bit-equal to an uninterrupted run on the CPU).
The reference runs as its own tests run it (``jax.jit``, the jnp pair)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.launch import ct_train as JCT

from repro_torch.core.projector import Projector
from repro_torch.launch import ct_train as TCT
from repro_torch.models.config import ModelConfig
from repro_torch.nn import params_from_reference
from repro_torch.optim import ema_init


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def tiny(geometry="sparse_fan", **kw):
    base = dict(geometry=geometry, n=12, steps=3, batch=2, base=8, levels=1,
                depth=1, warmup=1, ema_warmup=2, refine_iters=5,
                model="unet" if geometry != "limited_angle" else "auto")
    if geometry == "helical":
        base.update(n=20, nz=4)
    base.update(kw)
    return base


def _numpy_params(shapes, seed):
    """A reference parameter tree of ``shapes`` as the reference fills it
    (zero biases, unit group norm scales), its conv weights He-normal from a
    numpy seed; the U-Net's head too, where the reference starts at zero, so
    that every layer is in the first step's gradient."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "w":
            a = rng.standard_normal(leaf.shape).astype(np.float32)
            return jnp.asarray(a * np.sqrt(2.0 / np.prod(leaf.shape[:-1])))
        return jnp.full(leaf.shape, float(name == "scale"), jnp.float32)

    return compat.tree_map_with_path(fill, shapes)


class _RefTrainer(JCT.CTTrainer):
    """The reference trainer, its initial tree drawn from numpy (its
    structure from ``jax.eval_shape``): the reference's own initializer
    compiles op by op for ~20 s on this host."""

    def _init_params(self, key):
        return _numpy_params(jax.eval_shape(super()._init_params, key),
                             self.cfg.seed + 1)


def _carry(trainer, ref):
    """The reference trainer's parameters into the port's trainer."""
    trainer.params = {k: v.to(trainer.device) for k, v in params_from_reference(
        jax.tree.map(np.asarray, ref.params)).items()}
    trainer.opt_state = trainer.opt.init(trainer.params)
    trainer.ema = ema_init(trainer.params)


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(torch.sum((got[k] - want[k]) ** 2)) for k in want)
    return (num / sum(float(torch.sum(w ** 2)) for w in want.values())) ** 0.5


class _Run:
    """One geometry through both packages from the same parameters: one
    step's loss and gradients, then (``fit``) a 3-step fit of each."""

    def __init__(self, geometry: str, fit: bool):
        kw = tiny(geometry)
        self.ref = _RefTrainer(JCT.TrainConfig(**kw))
        self.port = TCT.CTTrainer(TCT.TrainConfig(**kw), device="cpu")
        _carry(self.port, self.ref)
        imgs, masks = self.ref.pipe.batch(0)
        gt = self.ref._as_volume(imgs)
        sino = self.ref.proj(gt)
        loss, grads = jax.jit(jax.value_and_grad(self.ref.loss_fn))(
            self.ref.params, sino, jnp.asarray(masks), gt)
        self.ref_loss = float(loss)
        self.ref_grads = params_from_reference(jax.tree.map(np.asarray, grads))
        loss, grads = self.port.grad_fn(self.port.params, *self.port.data(0))
        self.port_loss, self.port_grads = float(loss), grads
        if fit:
            self.ref_losses = self.ref.fit(log_every=0)
            self.port_losses = self.port.fit(log_every=0)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(geometry):
        if geometry not in cache:
            cache[geometry] = _Run(geometry, fit=geometry != "helical")
        return cache[geometry]
    return get


# --------------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [dict(geometry="cone_spiral"),
                                dict(geometry="helical", model="hybrid"),
                                dict(geometry="helical", nz=1), dict(n=4),
                                dict(dc_weight=-0.1), dict(model="resnet"),
                                dict(steps=0), dict(nz=-1)])
def test_config_validation(kw):
    with pytest.raises(ValueError):
        JCT.TrainConfig(**kw)
    with pytest.raises(ValueError):
        TCT.TrainConfig(**kw)


def test_config_auto_resolution():
    cfg = TCT.TrainConfig(geometry="limited_angle")
    assert cfg.nz == 1 and cfg.resolved_model == "hybrid"
    assert cfg.mask_mode == "limited_angle"
    cfg = TCT.TrainConfig(geometry="helical")
    assert cfg.nz == 8 and cfg.resolved_model == "unet"
    assert cfg.mask_mode == "few_view"
    assert cfg.replace(nz=4).nz == 4
    for g in TCT.GEOMETRIES:
        assert (dataclasses.asdict(TCT.smoke_config(g))
                == dataclasses.asdict(JCT.smoke_config(g)))


@pytest.mark.parametrize("geometry", TCT.GEOMETRIES)
def test_build_geometry_config_parity(geometry):
    for make in (lambda m: m.smoke_config(geometry),
                 lambda m: m.TrainConfig(**tiny(geometry)),
                 lambda m: m.TrainConfig(geometry=geometry, n=512)):
        tg, jg = TCT.build_geometry(make(TCT)), JCT.build_geometry(make(JCT))
        assert tg.to_config() == jg.to_config()
        assert tg.canonical_hash() == jg.canonical_hash()
        assert tg.n_angles >= 8


_LM = dict(name="m", family="dense", n_layers=1, d_model=8, n_heads=2,
           n_kv_heads=1, d_ff=16, vocab_size=32)


def test_entry_points_need_cuda_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        TCT.CTTrainer(TCT.TrainConfig(**tiny()))
    geom = TCT.build_geometry(TCT.TrainConfig(**tiny()))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        Projector.from_model_config(geom, ModelConfig(**_LM))


def test_projector_from_model_config_takes_its_compute_dtype():
    geom = TCT.build_geometry(TCT.TrainConfig(**tiny()))
    p = Projector.from_model_config(geom, ModelConfig(**_LM, compute_dtype="bfloat16"),
                                    device="cpu")
    assert p.compute_dtype == "bfloat16" and p.device.type == "cpu"
    p = Projector.from_model_config(geom, ModelConfig(**_LM), device="cpu",
                                    compute_dtype=None, backend="ref")
    assert p.compute_dtype is None and p.backend == "ref"


def test_data_parallel_on_one_device_runs_unsharded():
    t = TCT.CTTrainer(TCT.TrainConfig(**tiny(data_parallel=True, steps=1)),
                      device="cpu")
    assert len(t.fit(log_every=0)) == 1


# --------------------------------------------------------------------------- #
# the port against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("geometry", TCT.GEOMETRIES)
def test_one_step_matches_reference(runs, geometry):
    r = runs(geometry)
    assert set(r.port_grads) == set(r.ref_grads)
    np.testing.assert_allclose(r.port_loss, r.ref_loss, rtol=1e-5)
    assert _rel_l2(r.port_grads, r.ref_grads) < 1e-4
    # every network is in the gradient: the projector and the FBP carry it
    for net in ("unet", "ctnet") if geometry == "limited_angle" else ("unet",):
        assert any(float(g.abs().max()) > 0 for k, g in r.port_grads.items()
                   if k.startswith(net + ".levels.0") or k.startswith(net + ".layers.0"))


@pytest.mark.parametrize("geometry", ["limited_angle", "sparse_fan"])
def test_three_step_fit_matches_reference(runs, geometry):
    r = runs(geometry)
    assert len(r.port_losses) == 3 and all(np.isfinite(r.port_losses))
    np.testing.assert_allclose(r.port_losses, r.ref_losses, rtol=1e-4)


def test_evaluate_matches_reference(runs):
    r = runs("sparse_fan")
    got, want = r.port.evaluate(n_test=1), r.ref.evaluate(n_test=1)
    assert set(got) == set(want)
    for k in ("psnr_net", "psnr_refined"):
        assert abs(got[k] - want[k]) < 0.05, (k, got[k], want[k])
    for k in ("ssim_net", "ssim_refined", "dc_net", "dc_refined"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)
    assert got["dc_refined"] <= got["dc_net"] + 1e-6


# --------------------------------------------------------------------------- #
# the reference's own checks, on the port
# --------------------------------------------------------------------------- #
def test_hybrid_predict_returns_the_completed_sinogram():
    t = TCT.CTTrainer(TCT.TrainConfig(**tiny("limited_angle")), device="cpu")
    assert {k.split(".")[0] for k in t.params} == {"ctnet", "unet"}
    sino, mask, gt = t.data(0)
    m4 = mask[:, :, None, None]
    pred, completed = t.predict(t.params, sino * m4, mask)
    assert pred.shape == (2, 12, 12, 1)
    assert completed.shape == sino.shape
    keep = mask.bool()
    torch.testing.assert_close(completed[keep], (sino * m4)[keep], rtol=0, atol=0)


def test_loss_grads_flow_through_dc_term():
    """dc_weight changes the gradient: the projector is inside the
    differentiation path, not just the data generator."""
    on = TCT.CTTrainer(TCT.TrainConfig(**tiny(dc_weight=1.0)), device="cpu")
    off = TCT.CTTrainer(TCT.TrainConfig(**tiny(dc_weight=0.0)), device="cpu")
    off.params = on.params
    batch = on.data(0)
    _, g_on = on.grad_fn(on.params, *batch)
    _, g_off = off.grad_fn(off.params, *batch)
    assert sum(float((g_on[k] - g_off[k]).abs().sum()) for k in g_on) > 0


def test_checkpoint_roundtrip_full_trainer_state(tmp_path):
    cfg = TCT.TrainConfig(**tiny(steps=4, ckpt_dir=str(tmp_path / "ck"),
                                 ckpt_every=2))
    t1 = TCT.CTTrainer(cfg, device="cpu")
    assert len(t1.fit(log_every=0)) == 4
    t2 = TCT.CTTrainer(cfg, device="cpu")
    assert t2.resume() == 4 and t2.step == 4
    for a, b in ((t1.params, t2.params), (t1.ema.params, t2.ema.params),
                 (t1.opt_state.mu, t2.opt_state.mu),
                 (t1.opt_state.nu, t2.opt_state.nu)):
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(t2.opt_state.step) == int(t2.ema.step) == 4
    assert t2.opt_state.step.dtype == torch.int32
    assert t2.pipe.state_dict() == t1.pipe.state_dict()
    # fit() on the restored trainer is a no-op (schedule already finished)
    assert t2.fit(log_every=0) == []


def test_resume_without_checkpoint_is_fresh_start(tmp_path):
    t = TCT.CTTrainer(TCT.TrainConfig(**tiny(ckpt_dir=str(tmp_path / "never"))),
                      device="cpu")
    assert t.resume() == 0 and t.step == 0


class _Stop(Exception):
    pass


@pytest.fixture
def _one_torch_thread():
    """Torch's multi-threaded CPU kernels sum some gradients in an order
    that varies from run to run (last-bit differences); one thread is
    deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resumed_run_matches_the_uninterrupted_run(tmp_path, _one_torch_thread):
    """A run stopped after step 3 resumes from its step-2 checkpoint; its
    next losses are the uninterrupted run's, bit for bit (CPU)."""
    kw = tiny(steps=4, ckpt_every=2)
    full = TCT.CTTrainer(TCT.TrainConfig(**kw), device="cpu").fit(log_every=0)

    def stop(i, loss):
        if i == 2:
            raise _Stop

    cfg = TCT.TrainConfig(**kw, ckpt_dir=str(tmp_path / "ck"))
    with pytest.raises(_Stop):
        TCT.CTTrainer(cfg, device="cpu").fit(log_every=0, on_step=stop)
    again = TCT.CTTrainer(cfg, device="cpu")
    rest = again.fit(log_every=0)
    assert len(rest) == 2 and rest == full[2:]


def test_main_runs_the_smoke_gate_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "m.json"
    rc = TCT.main(["--geometry", "sparse_fan", "--smoke", "--steps", "2",
                   "--size", "12", "--n-test", "1", "--device", "cpu",
                   "--metrics-json", str(out)])
    assert rc == 0 and out.exists()
    assert "sparse_fan" in capsys.readouterr().out
    fails = TCT._check_run("g", [1.0, 1.0], {"psnr_net": 2.0, "psnr_refined": 1.0})
    assert len(fails) == 2

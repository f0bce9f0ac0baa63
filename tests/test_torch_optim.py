"""The port's optimizers, EMA and schedules (``repro_torch.optim``) against
the reference package's ``repro.optim``: the same numpy parameters and
gradients through 10 steps, values within rtol 1e-6 (atol 1e-9 on
entries that pass through zero).  The reference runs op by op, unjitted:
under ``jax.jit`` XLA fuses ``p + u`` into one rounding where both
packages' op-by-op arithmetic rounds twice.  The reference's semantics, not
``torch.optim``'s: ``b2`` 0.95, the schedule read at the 1-based step after
the increment, f32 state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J

from repro_torch import optim as T

TOL = dict(rtol=1e-6, atol=1e-9)
STEPS = 10
SHAPES = {"w": (3, 4), "b": (4,), "g": (2, 2, 3, 5)}


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _np_grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(d):
    return {k: torch.from_numpy(v.copy()) for k, v in d.items()}


def _close(got: dict, want: dict):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL,
                                   err_msg=k)


SCHEDULES = {
    "constant": (lambda m: m.constant(3e-3)),
    "linear_warmup": (lambda m: m.linear_warmup(2e-3, 4)),
    "cosine_decay": (lambda m: m.cosine_decay(1e-2, 7, alpha=0.2)),
    "warmup_cosine": (lambda m: m.warmup_cosine(2e-3, 3, 8)),
    "warmup_cosine_no_warmup": (lambda m: m.warmup_cosine(1e-3, 0, 5, alpha=0.0)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match(name):
    fj, ft = SCHEDULES[name](J), SCHEDULES[name](T)
    for step in range(0, STEPS + 3):
        want = np.asarray(fj(jnp.asarray(step, jnp.int32)))
        got = ft(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(ft(step).numpy(), want, rtol=1e-6)


def test_warmup_cosine_floor_is_alpha():
    f = T.warmup_cosine(1.0, 2, 6)
    assert float(f(6)) == pytest.approx(0.1) and float(f(60)) == pytest.approx(0.1)


OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(m.warmup_cosine(2e-3, 3, STEPS))),
    "adamw_wd": (lambda m: m.adamw(m.constant(1e-2), b1=0.8, weight_decay=0.05)),
    "sgd": (lambda m: m.sgd(m.linear_warmup(0.1, 3))),
    "sgd_momentum": (lambda m: m.sgd(m.constant(0.05), momentum=0.9)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_over_ten_steps(name):
    oj, ot = OPTIMIZERS[name](J), OPTIMIZERS[name](T)
    pj, pt = _np_params(), _t(_np_params())
    sj, st = oj.init(pj), ot.init(pt)
    for i in range(STEPS):
        g = _np_grads(i)
        uj, sj = oj.update(g, sj, pj)
        ut, st = ot.update(_t(g), st, pt)
        _close(ut, uj)
        pj = J.apply_updates(pj, uj)
        pt = T.apply_updates(pt, ut)
        _close(pt, pj)
        assert int(st.step) == int(sj.step) == i + 1
    if name.startswith("adamw"):
        _close(st.mu, sj.mu)
        _close(st.nu, sj.nu)
        assert all(v.dtype == torch.float32 for v in st.mu.values())


def test_adamw_defaults_are_the_references():
    """b2 = 0.95: one step from zero state with a constant gradient moves
    the second moment to 0.05 g^2, which torch's 0.999 would not."""
    opt = T.adamw(T.constant(1.0))
    p = {"x": torch.zeros(3)}
    g = {"x": torch.tensor([1.0, -2.0, 4.0])}
    u, s = opt.update(g, opt.init(p), p)
    torch.testing.assert_close(s.nu["x"], 0.05 * g["x"] ** 2)
    torch.testing.assert_close(u["x"], -torch.sign(g["x"]), rtol=1e-6, atol=1e-7)


def test_clip_by_global_norm_matches():
    g = _np_grads(3)
    for max_norm in (0.5, 1e6):
        cj, nj = J.clip_by_global_norm(g, max_norm)
        ct, nt = T.clip_by_global_norm(_t(g), max_norm)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        _close(ct, cj)


@pytest.mark.parametrize("decay,warmup", [(0.999, 10), (0.9, 1), (0.5, 3)])
def test_ema_matches_over_ten_steps(decay, warmup):
    pj = _np_params(1)
    ej, et = J.ema_init(pj), T.ema_init(_t(pj))
    _close(et.params, pj)                       # starts at the parameters
    for i in range(STEPS):
        p = {k: v + _np_grads(i)[k] for k, v in pj.items()}
        ej = J.ema_update(ej, p, decay=decay, warmup=warmup)
        et = T.ema_update(et, _t(p), decay=decay, warmup=warmup)
        _close(T.ema_params(et), J.ema_params(ej))
        assert int(et.step) == int(ej.step) == i + 1
        np.testing.assert_allclose(
            T.ema_decay_schedule(et.step, decay, warmup).numpy(),
            np.asarray(J.ema_decay_schedule(ej.step, decay, warmup)), rtol=1e-6)


def test_ema_keeps_dtype_and_copies():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    e = T.ema_init(p)
    p["w"].add_(1.0)
    assert float(e.params["w"][0]) == 1.0
    e = T.ema_update(e, p, decay=0.5, warmup=1)
    assert e.params["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [dict(decay=1.0), dict(decay=-0.1), dict(warmup=0)])
def test_ema_rejects_bad_arguments(kw):
    e = T.ema_init({"w": torch.zeros(2)})
    with pytest.raises(ValueError):
        T.ema_update(e, {"w": torch.zeros(2)}, **kw)

"""The port's fault-tolerance and gradient-compression runtime
(``repro_torch.runtime.{fault,compression}``) against the reference
package's ``repro.runtime.{fault,compression}`` on the same numpy inputs.

* ``FleetMonitor``: dead hosts and stragglers over seeded heartbeats (hosts
  missing, late, slow, within and past the grace steps), and the reference
  tests' own case.
* ``plan_remesh`` over a grid of chip counts, model axes and pod counts.
* ``Supervisor``: restarts and resumes, gives up with the reference's
  message, and lets an interrupt through.
* ``compress`` (values and residuals within 1e-6 of each leaf's largest:
  the leaf's mean is summed in another order, so the scale may be an ulp
  apart, and the residual x - q carries that ulp) and ``compressed_bytes``
  on seeded trees, and error feedback still minimizing a quadratic.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as jcomp
from repro.runtime import fault as jfault

from repro_torch.runtime import compression as tcomp
from repro_torch.runtime import fault as tfault


def _heartbeats(mod, seed: int, now: float):
    """A monitor of 12 hosts fed seeded heartbeats: some hosts never beat,
    some beat late, step times log-normal with a few slow hosts, steps on
    both sides of the grace."""
    rng = np.random.default_rng(seed)
    mon = mod.FleetMonitor(n_hosts=12, timeout_s=30.0, grace_steps=5)
    for h in range(12):
        if rng.random() < 0.15:
            continue                                   # never heard from
        dt = float(rng.lognormal(0.0, 0.1))
        if rng.random() < 0.2:
            dt *= float(rng.uniform(2.0, 6.0))         # a slow host
        age = float(rng.choice([0.0, 10.0, 45.0], p=[0.7, 0.2, 0.1]))
        mon.heartbeat(mod.HostStatus(h, step=int(rng.integers(0, 12)),
                                     step_time_s=dt, timestamp=now - age))
    return mon


@pytest.mark.parametrize("seed", range(6))
def test_fleet_monitor_matches_reference(seed):
    now = 1.0e6
    mine, ref = _heartbeats(tfault, seed, now), _heartbeats(jfault, seed, now)
    for t in (now, now + 20.0, now + 100.0):
        assert mine.dead_hosts(t) == ref.dead_hosts(t)
    assert mine.stragglers() == ref.stragglers()


def test_fleet_monitor_reference_case():
    """tests/test_runtime.py's case: host 3 is 5x slower."""
    mon = tfault.FleetMonitor(n_hosts=8, timeout_s=10.0, grace_steps=0)
    now = time.time()
    for h in range(8):
        mon.heartbeat(tfault.HostStatus(h, step=100, step_time_s=5.0 if h == 3
                                        else 1.0, timestamp=now))
    assert mon.dead_hosts(now) == []
    assert mon.stragglers() == [3]
    assert mon.dead_hosts(now + 100) == list(range(8))


@pytest.mark.parametrize("pods", [1, 2, 4])
def test_plan_remesh_matches_reference(pods):
    for model_axis in (1, 2, 4, 8, 16):
        for chips in list(range(0, 80)) + list(range(250, 1100, 37)) + [512, 511]:
            assert (tfault.plan_remesh(chips, model_axis, pods)
                    == jfault.plan_remesh(chips, model_axis, pods)), \
                (chips, model_axis, pods)


def _supervised(mod, fail_times: int, max_restarts: int):
    calls = []

    def loop(start):
        calls.append(start)
        if len(calls) <= fail_times:
            raise RuntimeError("injected")
        return 100

    sup = mod.Supervisor(loop, lambda: len(calls) * 10,
                         max_restarts=max_restarts, backoff_s=0.0)
    try:
        out = sup.run()
    except RuntimeError as e:
        out = (str(e), str(e.__cause__))
    return out, calls, sup.restarts


@pytest.mark.parametrize("fail_times,max_restarts", [(0, 2), (2, 5), (3, 3),
                                                     (4, 3), (1, 0)])
def test_supervisor_matches_reference(fail_times, max_restarts):
    assert (_supervised(tfault, fail_times, max_restarts)
            == _supervised(jfault, fail_times, max_restarts))


def test_supervisor_passes_interrupts_through():
    def loop(start):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        tfault.Supervisor(loop, lambda: 0, max_restarts=5, backoff_s=0.0).run()


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(7, 5)).astype(np.float32),
                  "b": rng.normal(size=(5,)).astype(np.float32)},
            "c": (rng.normal(size=(3, 4, 2)) * 1e-3).astype(np.float32)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_compress_matches_reference(seed):
    """Three steps of error feedback from a zero residual on seeded
    gradients: the transmitted values and the residuals."""
    jres, tres = jcomp.init_state(_tree(0)), tcomp.init_state(_to_torch(_tree(0)))
    for step in range(3):
        g = _tree(100 * seed + step)
        jq, jres = jcomp.compress(jax.tree.map(jnp.asarray, g), jres)
        tq, tres = tcomp.compress(_to_torch(g), tres)
        for what, mine, ref in (("q", tq, jq), ("res", tres, jres)):
            ref = _flat(ref)
            for k, v in _flat(mine).items():
                np.testing.assert_allclose(
                    v, ref[k], rtol=0, atol=1e-6 * float(np.abs(ref[k]).max()),
                    err_msg=f"{what} {k} step {step}")
                assert v.dtype == ref[k].dtype
    assert tcomp.compressed_bytes(_to_torch(_tree(seed))) == \
        jcomp.compressed_bytes(_tree(seed))


def test_compress_keeps_the_gradient_dtype():
    g = {"w": torch.randn(4, 4, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16)}
    q, res = tcomp.compress(g, tcomp.init_state(g))
    assert q["w"].dtype == torch.bfloat16 and res["w"].dtype == torch.float32
    assert q["w"].abs().unique().numel() == 1          # sign times one scale


def test_compression_error_feedback_convergence():
    """1-bit EF SGD still minimizes a quadratic (tests/test_runtime.py)."""
    A = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 16)))
    Q = A @ A.T / 16 + 0.5 * torch.eye(16, dtype=A.dtype)
    params = {"x": torch.ones(16, dtype=A.dtype) * 5.0}
    res = tcomp.init_state(params)
    for _ in range(300):
        q, res = tcomp.compress({"x": Q @ params["x"]}, res)
        params = {"x": params["x"] - 0.05 * q["x"]}
    assert float(torch.linalg.vector_norm(params["x"])) < 0.3

"""Data-parallel CT training on ``torch.distributed``, on the CPU: a gloo
world of two ranks against one device.

* ``launch.train.make_ct_dp_train_step`` (the reference's
  ``tests/test_distributed_ct.py:364-387``): 5 SGD steps on 2 ranks against
  the step on one device on the full batch (losses rtol 1e-5, parameters
  atol 1e-6: the step is linear in the gradient, which the two runs sum in
  another order), and the loss falls at every step.
* ``CTTrainer(data_parallel=True)`` at ``smoke_config`` (limited angle, 3
  steps): the first batch's loss (rtol 1e-5) and gradients averaged over
  the two ranks (relative L2 of all gradients 1e-5) against one device on
  the whole batch, the 3 losses (rtol 1e-5), and every parameter within
  2 x 3 x lr of one device's.  AdamW moves a parameter by at most about lr
  a step whatever its gradient, and the convolution biases in front of a
  group norm have gradients that are rounding noise (~1e-9), which AdamW
  scales up to steps of lr; so the parameters are held to the optimizer's
  bound, and the gradients carry the check.  Both ranks hold the same
  parameters, bit for bit.
* A batch that does not divide over the data axis raises, with the
  reference's message.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_world

import torch_dist_worlds as W

CFG = dict(geometry="limited_angle", steps=3)


@pytest.fixture(scope="module")
def world_dp():
    return run_world(W.world_dp, 2, backend="gloo", timeout=600, args=(CFG,))


@pytest.fixture(scope="module")
def one_device():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        return {"step": W.dp_step_run(None), "trainer": W.trainer_run(CFG)}
    finally:
        torch.set_num_threads(n)


def test_dp_train_step_matches_one_device(world_dp, one_device):
    losses, vol = one_device["step"]
    for r in world_dp:
        got_losses, got_vol = r["step"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        np.testing.assert_allclose(got_vol, vol, rtol=0, atol=1e-6)


def test_dp_train_step_decreases_loss(world_dp):
    losses = world_dp[0]["step"][0]
    assert all(b < a for a, b in zip(losses, losses[1:]))


def test_trainer_gradients_match_one_device(world_dp, one_device):
    want = one_device["trainer"]
    for r in world_dp:
        got = r["trainer"]
        assert got["loss0"] == pytest.approx(want["loss0"], rel=1e-5)
        a = np.concatenate([got["grads0"][k].ravel() for k in want["grads0"]])
        b = np.concatenate([want["grads0"][k].ravel() for k in want["grads0"]])
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)


def test_trainer_steps_match_one_device(world_dp, one_device):
    want = one_device["trainer"]
    lr = 2e-3                                   # smoke_config's
    bound = 2 * CFG["steps"] * lr
    for r in world_dp:
        got = r["trainer"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=bound, err_msg=k)
    a, b = (r["trainer"]["params"] for r in world_dp)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_trainer_indivisible_batch_raises(world_dp):
    kind, msg = world_dp[0]["indivisible"]
    assert kind == "ValueError"
    assert msg == "batch=3 must divide over the 2-way data axis"

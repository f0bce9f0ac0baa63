"""The port's recon networks (``repro_torch.nn``) against the reference
package's ``repro.nn`` on the same numpy inputs: every layer, the U-Net and
CT-Net with the reference's parameters carried across by
``params_from_reference``, forward (layers: rtol 1e-5, atol 1e-6;
networks: rtol 1e-5 and an absolute 2e-6 of the largest output, since their
O(1) outputs carry ~1e-6 of the largest in f32 rounding through the layers'
sums and group norms) and gradients (rtol 1e-4 element by element, and an
absolute 1e-4 of the largest entry: a conv bias ahead of a group norm whose
groups hold one channel has a gradient that is zero in exact arithmetic,
and both frameworks give rounding noise of up to ~1e-5 of the largest entry
there; and 1e-5 in relative L2 over all the gradients)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro import compat
from repro.nn import modules as JM
from repro.nn.ctnet import ctnet_apply, ctnet_init
from repro.nn.unet import unet_apply, unet_init

from repro_torch.nn import CTNet, UNet, count_params, params_from_reference
from repro_torch.nn import modules as TM

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _net_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-6 * float(np.abs(want).max()))


def _grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=1e-4 * scale, err_msg=k)
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(want[k] ** 2)) for k in want)
    assert np.sqrt(num / den) < 1e-5


def _torch_grads(module, params, fn):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = fn(lambda *a: functional_call(module, leaves, a))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {k: g.numpy() for k, g in zip(leaves, grads)}


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2), (4, 2)])
def test_conv2d_same(k, stride):
    x = _rand((2, 9, 11, 3), 0)
    p = jax.tree.map(np.asarray, JM.conv2d_init(jax.random.PRNGKey(1), 3, 5, k=k))
    p["b"] = _rand((5,), 2)
    want = np.asarray(JM.conv2d(p, x, stride=stride))
    sd = params_from_reference(p)
    got = TM.conv2d(_nchw(x), sd["weight"], sd["bias"], stride=stride)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, **FWD)


@pytest.mark.parametrize("k", [3, 2])
def test_conv2d_transpose(k):
    x = _rand((2, 5, 6, 3), 3)
    p = {"w": _rand((k, k, 3, 4), 4), "b": _rand((4,), 5)}
    want = np.asarray(JM.conv2d_transpose(p, x, stride=2))
    sd = params_from_reference(p)
    got = TM.conv2d_transpose(_nchw(x), sd["weight"], sd["bias"], stride=2)
    assert got.shape == (2, 4, 10, 12)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, **FWD)


def test_dense():
    x = _rand((3, 7), 6)
    p = jax.tree.map(np.asarray, JM.dense_init(jax.random.PRNGKey(2), 7, 4))
    p["b"] = _rand((4,), 7)
    sd = params_from_reference(p)
    np.testing.assert_allclose(TM.dense(torch.from_numpy(x), sd["weight"],
                                        sd["bias"]).numpy(),
                               np.asarray(JM.dense(p, x)), **FWD)


@pytest.mark.parametrize("ch", [1, 6, 12, 16, 40])
def test_group_norm_keeps_the_group_fallback(ch):
    x = _rand((2, 5, 4, ch), 8) * 3.0 + 1.0
    p = {"scale": _rand((ch,), 9), "bias": _rand((ch,), 10)}
    want = np.asarray(JM.group_norm(p, x))
    g = min(8, ch)
    while ch % g:
        g -= 1
    assert TM.norm_groups(ch) == g
    got = TM.group_norm(_nchw(x), torch.from_numpy(p["scale"]),
                        torch.from_numpy(p["bias"]))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, **FWD)


def test_silu_pool_upsample():
    x = _rand((2, 7, 9, 3), 11)      # odd sizes: VALID pooling drops the edge
    t = _nchw(x)
    for got, want in ((TM.silu(t), JM.silu(x)),
                      (TM.avg_pool(t), JM.avg_pool(x)),
                      (TM.upsample_nearest(t), JM.upsample_nearest(x))):
        np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                                   np.asarray(want), **FWD)


# --------------------------------------------------------------------------- #
# networks, with carried weights
# --------------------------------------------------------------------------- #
UNET_CASES = [(4, 4, 1), (3, 1, 2)]          # in_ch, out_ch, levels


def _numpy_tree(init, seed):
    """The reference initializer's tree (its structure and shapes, through
    ``jax.eval_shape``: nothing compiled) filled from a numpy seed: conv
    weights He-normal, every other leaf nonzero (the reference's zero head
    and zero biases would leave paths untested)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "w":
            return a * np.float32(np.sqrt(2.0 / np.prod(leaf.shape[:-1])))
        return a * np.float32(0.1) + np.float32(name == "scale")

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return compat.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def unet_trees():
    return {(i, o, lv): _numpy_tree(functools.partial(
        unet_init, base=8, levels=lv, in_ch=i, out_ch=o), seed)
        for seed, (i, o, lv) in enumerate(UNET_CASES)}


@pytest.fixture(scope="module")
def ctnet_tree():
    return _numpy_tree(functools.partial(ctnet_init, base=8, depth=3), 3)


@pytest.mark.parametrize("in_ch,out_ch,levels", UNET_CASES)
def test_unet_forward_and_gradients(unet_trees, in_ch, out_ch, levels):
    tree = unet_trees[in_ch, out_ch, levels]
    x = _rand((2, 16, 12, in_ch), 14) * 0.02
    r = _rand((2, 16, 12, out_ch), 15)
    net = UNet(base=8, levels=levels, in_ch=in_ch, out_ch=out_ch)
    sd = params_from_reference(tree)
    assert set(sd) == set(net.state_dict())
    assert all(sd[k].shape == v.shape for k, v in net.state_dict().items())
    assert count_params(net) == sum(a.size for a in jax.tree.leaves(tree))

    want = np.asarray(jax.jit(unet_apply)(tree, x))
    got = functional_call(net, sd, (_nchw(x),))
    _net_close(np.moveaxis(got.detach().numpy(), 1, -1), want)

    jg = jax.jit(jax.grad(lambda p: jnp.sum(unet_apply(p, x) * r)))(tree)
    want_g = {k: v.numpy() for k, v in params_from_reference(
        jax.tree.map(np.asarray, jg)).items()}
    got_g = _torch_grads(net, sd, lambda f: torch.sum(f(_nchw(x)) * _nchw(r)))
    _grads_close(got_g, want_g)


def test_unet_starts_as_the_identity():
    net = UNet(base=8, levels=2, in_ch=3, out_ch=2,
               generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_nchw(_rand((2, 8, 8, 3), 16)).numpy())
    assert torch.equal(net(x), x[:, :2])


def test_ctnet_forward_and_gradients(ctnet_tree):
    tree = ctnet_tree
    sino = _rand((2, 12, 20), 17)
    mask = np.zeros((2, 12, 20), np.float32)
    mask[:, :7] = 1.0
    r = _rand((2, 12, 20), 18)
    net = CTNet(base=8, depth=3)
    sd = params_from_reference(tree)
    assert set(sd) == set(net.state_dict())
    assert [net.layers[i].c.weight.shape[0] for i in range(3)] == [8, 16, 32]

    want = np.asarray(jax.jit(ctnet_apply)(tree, sino * mask, mask))
    s, m = torch.from_numpy(sino * mask), torch.from_numpy(mask)
    got = functional_call(net, sd, (s, m)).detach().numpy()
    _net_close(got, want)
    np.testing.assert_array_equal(got[:, :7], (sino * mask)[:, :7])

    jg = jax.jit(jax.grad(
        lambda p: jnp.sum(ctnet_apply(p, sino * mask, mask) * r)))(tree)
    want_g = {k: v.numpy() for k, v in params_from_reference(
        jax.tree.map(np.asarray, jg)).items()}
    got_g = _torch_grads(net, sd, lambda f: torch.sum(f(s, m) * torch.from_numpy(r)))
    _grads_close(got_g, want_g)


def test_params_from_reference_maps_the_trainer_tree(unet_trees, ctnet_tree):
    tree = {"ctnet": ctnet_tree, "unet": unet_trees[3, 1, 2]}
    sd = params_from_reference(tree)
    w = tree["unet"]["levels"][1]["c2"]["w"]
    np.testing.assert_array_equal(sd["unet.levels.1.c2.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["unet.ups.0.n1.weight"].numpy(),
                                  tree["unet"]["ups"][0]["n1"]["scale"])
    np.testing.assert_array_equal(sd["ctnet.out.bias"].numpy(),
                                  tree["ctnet"]["out"]["b"])
    assert len(sd) == len(jax.tree.leaves(tree))

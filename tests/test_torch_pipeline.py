"""The port's data pipeline and checkpoints against the reference package's:
``CTDataPipeline`` batches, masks and ``state_dict`` bit-equal to
``repro.data.pipeline``'s for the three training geometries and every mask
mode; ``runtime/checkpoint.py``'s layout (a checkpoint written by either
package restores in the other), atomic pointer, garbage collection, errors,
and the asynchronous save's snapshot.  Every file goes under ``tmp_path``;
every thread started is joined (``wait``) or is the prefetcher's daemon,
which no assertion waits on beyond the items it has produced."""
import json
import os

import numpy as np
import pytest
import torch

from repro.data.pipeline import CTDataPipeline as JPipe
from repro.launch import ct_train as JCT
from repro.runtime import checkpoint as JCK

from repro_torch.data.pipeline import CTDataPipeline
from repro_torch.launch import ct_train as TCT
from repro_torch.runtime import checkpoint as CK


def _geoms(geometry):
    cfg = dict(geometry=geometry, n=16)
    if geometry == "helical":
        cfg["nz"] = 4
    return (JCT.build_geometry(JCT.TrainConfig(**cfg)),
            TCT.build_geometry(TCT.TrainConfig(**cfg)))


CASES = [("limited_angle", "limited_angle"), ("sparse_fan", "few_view"),
         ("helical", "few_view"), ("sparse_fan", "full")]


@pytest.mark.parametrize("geometry,mode", CASES)
def test_batches_and_masks_bit_equal(geometry, mode):
    jg, tg = _geoms(geometry)
    kw = dict(batch_size=4, seed=7, mode=mode, available_deg=45.0,
              n_views_few=9, shard_index=1, shard_count=2)
    jp, tp = JPipe(jg, **kw), CTDataPipeline(tg, **kw)
    for step in (0, 3, 11):
        (ji, jm), (ti, tm) = jp.batch(step), tp.batch(step)
        assert ti.dtype == ji.dtype == np.float32 and tm.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)
    assert ti.shape == (2,) + tg.vol.shape[:2] + ((tg.vol.nz,) if tg.vol.nz > 1 else ())
    img, mask = tp.sample(10_000, 0)
    np.testing.assert_array_equal(img, jp.sample(10_000, 0)[0])
    n_on = {"limited_angle": round(tg.n_angles * 45.0 / 180.0), "few_view": 9,
            "full": tg.n_angles}[mode]
    assert int(mask.sum()) == n_on
    assert tp.state_dict() == jp.state_dict()


def test_helical_samples_blend_two_keyframes():
    _, tg = _geoms("helical")
    img, _ = CTDataPipeline(tg, 1, seed=3).sample(0, 0)
    mid = 0.5 * (img[..., 0] + img[..., -1])
    assert not np.array_equal(img[..., 0], img[..., -1])
    np.testing.assert_allclose(img[..., 1:-1].mean(-1), mid, rtol=1e-5, atol=1e-7)


_EDGE_ELLIPSES = [  # (cx, cy, a, b, angle, rho) in mm
    (0.0, 0.0, 300.0, 20.0, np.pi / 4, 1.0),        # thin, 45 deg, past the edges
    (250.0, -250.0, 80.0, 40.0, 2.0, 0.5),          # across a corner
    (-100.0, 60.0, 0.3, 0.2, 0.3, 0.7),             # smaller than a sample
    (10.0, 10.0, 50.0, 50.0, 0.0, 0.25),            # circle, no rotation
    (900.0, 0.0, 30.0, 30.0, 1.0, 1.0),             # wholly outside
]


@pytest.mark.parametrize("n,ny,dx,offset,ss,seed", [
    (512, 512, 1.0, 0.0, 2, 0), (512, 512, 1.0, 0.0, 2, 1),
    (512, 512, 1.0, 0.0, 1, 2), (300, 200, 0.7, 13.3, 3, 3)])
def test_rasterize_bit_equal_to_the_reference(n, ny, dx, offset, ss, seed):
    """The port's rasterizer, which tests each ellipse on its bounding box
    only, gives the reference's whole-grid image bit for bit: rotated random
    phantoms at n = 512 and edge cases on an offset, non-square volume."""
    from repro.core.geometry import VolumeGeometry as JVol
    from repro.data import phantoms as JP
    from repro_torch.core.geometry import VolumeGeometry
    from repro_torch.data import phantoms as P
    kw = dict(nx=n, ny=ny, nz=1, dx=dx, dy=dx, offset_x=offset, offset_y=-offset)
    tv, jv = VolumeGeometry(**kw), JVol(**kw)
    ells = P.random_ellipses(np.random.default_rng(seed), tv)
    ells += [P.Ellipse(*e) for e in _EDGE_ELLIPSES]
    want = JP.rasterize([JP.Ellipse(**vars(e)) for e in ells], jv, ss)
    got = P.rasterize(ells, tv, ss)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_state_dict_round_trip_and_seed_mismatch():
    _, tg = _geoms("sparse_fan")
    p = CTDataPipeline(tg, 2, seed=1, mode="few_view", n_views_few=8)
    it = iter(p)
    first = [next(it) for _ in range(3)]
    q = CTDataPipeline(tg, 2, seed=1, mode="few_view", n_views_few=8)
    q.load_state_dict({"seed": 1, "step": 1})
    np.testing.assert_array_equal(q.batch(q.step)[0], first[1][0])
    with pytest.raises(ValueError, match="seed mismatch"):
        q.load_state_dict({"seed": 2, "step": 0})
    with pytest.raises(ValueError, match="divisible"):
        CTDataPipeline(tg, 3, shard_count=2)


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"a.weight": rng.standard_normal((3, 2)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float32)},
            "opt": [np.asarray(5, np.int32), rng.standard_normal(2).astype(np.float32)]}


def _torch_tree(seed=0):
    t = _tree(seed)
    return {"params": {k: torch.from_numpy(v) for k, v in t["params"].items()},
            "opt": [torch.from_numpy(v) for v in t["opt"]]}


def test_layout_and_round_trip(tmp_path):
    d = str(tmp_path / "ck")
    CK.save(d, 12, _torch_tree(), {"data": {"seed": 0, "step": 12}})
    assert sorted(os.listdir(d)) == ["LATEST", "step_0000000012"]
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read() == "step_0000000012"
    with open(os.path.join(d, "step_0000000012", "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 12 and man["extra"] == {"data": {"seed": 0, "step": 12}}
    assert sorted(os.listdir(os.path.join(d, "step_0000000012"))) == sorted(
        [m["file"] for m in man["leaves"].values()] + ["manifest.json"])
    assert CK.latest_step(d) == 12
    back, extra, step = CK.restore(d, _torch_tree(1))
    assert step == 12 and extra["data"]["step"] == 12
    for k, v in _torch_tree()["params"].items():
        assert torch.equal(back["params"][k], v)
    assert isinstance(back["opt"], list) and int(back["opt"][0]) == 5


def test_checkpoints_cross_between_packages(tmp_path):
    """The same tree, saved by either package, restores in the other."""
    JCK.save(str(tmp_path / "j"), 3, _tree(), {"x": 1})
    back, extra, step = CK.restore(str(tmp_path / "j"), _torch_tree(1))
    assert (step, extra) == (3, {"x": 1})
    np.testing.assert_array_equal(back["params"]["b"].numpy(), _tree()["params"]["b"])
    CK.save(str(tmp_path / "t"), 4, _torch_tree(), {"y": 2})
    jback, _, jstep = JCK.restore(str(tmp_path / "t"), _tree(1))
    assert jstep == 4
    np.testing.assert_array_equal(np.asarray(jback["opt"][1]), _tree()["opt"][1])


def test_restore_errors(tmp_path):
    d = str(tmp_path / "ck")
    assert CK.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        CK.restore(d, _torch_tree())
    CK.save(d, 1, _torch_tree())
    bad = _torch_tree()
    bad["params"]["b"] = torch.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        CK.restore(d, bad)
    more = _torch_tree()
    more["params"]["c"] = torch.zeros(1)
    with pytest.raises(ValueError, match="missing"):
        CK.restore(d, more)


def test_async_save_keeps_three_and_snapshots_a_copy(tmp_path):
    d = str(tmp_path / "ck")
    ck = CK.AsyncCheckpointer(d, keep=3)
    tree = _torch_tree()
    before = tree["params"]["b"].clone()
    for step in range(1, 6):
        ck.save(step, tree)
        # the next step's in-place update, while the writer may still run
        tree["params"]["b"].add_(1.0)
    ck.wait()
    assert ck._thread is None
    assert sorted(os.listdir(d)) == ["LATEST", "step_0000000003",
                                     "step_0000000004", "step_0000000005"]
    for step in (3, 4, 5):
        back, _, _ = CK.restore(d, tree, step=step)
        assert torch.equal(back["params"]["b"], before + (step - 1))


def test_a_stale_tmp_dir_does_not_block_a_save(tmp_path):
    d = tmp_path / "ck"
    (d / "step_0000000002.tmp").mkdir(parents=True)
    (d / "step_0000000002.tmp" / "junk.npy").write_bytes(b"x")
    CK.save(str(d), 2, _torch_tree())
    assert sorted(os.listdir(d)) == ["LATEST", "step_0000000002"]
    assert CK.restore(str(d), _torch_tree())[2] == 2

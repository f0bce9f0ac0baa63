"""The port's geometry, spec and per-view tables against the reference
package: identical configs and hashes for all five geometry kinds, and
bit-identical kernel tables."""
import numpy as np
import pytest

import repro.core.geometry as jgeo
from repro.kernels import fp_par as jfp_par
from repro.kernels import ref as jref

import repro_torch.core.geometry as tgeo
from repro_torch.core.spec import ProjectorSpec
from repro_torch.kernels import fp_par as tfp_par
from repro_torch.kernels.tune import KernelConfig


def _kinds(G):
    vol = G.VolumeGeometry(16, 16, 8, dx=1.25, dy=1.25, dz=2.0, offset_x=0.5,
                           offset_z=-1.0)
    return {
        "parallel": G.parallel_beam(9, 4, 24, vol, pixel_width=1.1,
                                    center_col=0.3),
        "fan": G.fan_beam(8, 4, 30, vol, sod=120.0, sdd=240.0,
                          pixel_width=2.0, detector_type="curved"),
        "cone": G.cone_beam(8, 12, 36, vol, sod=120.0, sdd=240.0,
                            pixel_width=2.0, pixel_height=2.0),
        "modular": G.cone_as_modular(G.cone_beam(
            6, 8, 24, vol, sod=80.0, sdd=160.0, pixel_width=2.0,
            pixel_height=2.0)),
        "helical": G.helical_beam(1.5, 8.0, 12, 8, 24, vol, sod=80.0,
                                  sdd=160.0, pixel_width=2.0),
    }


@pytest.mark.parametrize("kind", ["parallel", "fan", "cone", "modular",
                                  "helical"])
def test_config_and_hash_match_reference(kind):
    g_j, g_t = _kinds(jgeo)[kind], _kinds(tgeo)[kind]
    assert g_t.to_config() == g_j.to_config()
    assert g_t.canonical_hash() == g_j.canonical_hash()
    back = tgeo.from_config(g_j.to_config())
    assert back.canonical_hash() == g_j.canonical_hash()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(dx=1.5, dy=1.5, dz=2.0, offset_x=1.3, offset_y=-0.7),
])
def test_view_params_and_z_overlap_bit_identical(kw):
    angles = np.linspace(0.0, np.pi, 23, endpoint=False) + 0.01
    g_j = jgeo.parallel_beam(23, 6, 30, jgeo.VolumeGeometry(20, 20, 4, **kw),
                             pixel_width=1.1, pixel_height=1.3, angles=angles)
    g_t = tgeo.parallel_beam(23, 6, 30, tgeo.VolumeGeometry(20, 20, 4, **kw),
                             pixel_width=1.1, pixel_height=1.3, angles=angles)
    for a, b in zip(tfp_par._view_params(g_t), jfp_par._view_params(g_j)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(tfp_par._z_overlap_matrix(g_t),
                          jref._z_overlap_matrix(g_j))


def test_spec_identity_and_keys():
    g1 = _kinds(tgeo)["parallel"]
    g2 = tgeo.from_config(g1.to_config())
    a = ProjectorSpec(g1, compute_dtype="bf16")
    b = ProjectorSpec(g2, compute_dtype="bfloat16")
    assert a == b and hash(a) == hash(b)
    assert a.cache_key(in_dtype="float32") == b.cache_key(in_dtype="float32")
    assert a.bucket_key() == b.bucket_key()
    c = ProjectorSpec(g1, config=KernelConfig(bu=64, bg=64, lg=2))
    assert c.bucket_key() != ProjectorSpec(g1).bucket_key()
    with pytest.raises(ValueError):
        ProjectorSpec(g1, backend="pallas")
    with pytest.raises(ValueError):
        ProjectorSpec(g1, compute_dtype="float16")
    with pytest.raises(ValueError):
        KernelConfig(bu=512, lg=4)


@pytest.mark.parametrize("reduced", [False, True])
def test_leap_ct_workloads_equal_the_reference(reduced):
    """configs/leap_ct.py: the Table-1 cells and the limited-angle shape are
    the reference's geometries (same config, same hash)."""
    from repro.configs import leap_ct as jleap
    from repro_torch.configs import leap_ct as tleap
    jc, tc = jleap.table1_geometries(reduced), tleap.table1_geometries(reduced)
    assert list(jc) == list(tc)
    for name in jc:
        assert tc[name].to_config() == jc[name].to_config(), name
        assert tc[name].canonical_hash() == jc[name].canonical_hash(), name
    for args in ((), (64, 90)):
        a, b = jleap.limited_angle_geometry(*args), tleap.limited_angle_geometry(*args)
        assert b.to_config() == a.to_config()
        assert b.canonical_hash() == a.canonical_hash()


def test_leap_ct_gives_the_card_cells_geometries():
    """chip_smoke.py's main, 3d and cone cells come from configs/leap_ct.py:
    the same geometries it built inline before (same hash)."""
    from repro_torch.configs import leap_ct as tleap
    V = tgeo.VolumeGeometry
    t1 = tleap.table1_geometries()
    pairs = [
        (tleap.limited_angle_geometry(512, 720),
         tgeo.parallel_beam(720, 1, 768, V(512, 512, 1), angular_range=180.0)),
        (t1["parallel_512_180"],
         tgeo.parallel_beam(180, 512, 768, V(512, 512, 512), angular_range=180.0)),
        (t1["cone_512_180"],
         tgeo.cone_beam(180, 512, 768, V(512, 512, 512), sod=1024.0, sdd=2048.0,
                        pixel_width=2.0, pixel_height=2.0, angular_range=360.0)),
    ]
    for a, b in pairs:
        assert a.canonical_hash() == b.canonical_hash()

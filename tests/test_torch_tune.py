"""The port's tuner (``repro_torch.kernels.tune``): shape classes against the
reference package's, the registry, resolution in the kernel entry points,
the autotuner off the card and the disk cache, mirroring
``tests/test_tune.py``."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.geometry as jgeo
from repro.kernels import tune as jtune

import repro_torch.core.geometry as tgeo
from repro_torch.kernels import fp_fan, fp_par, tune
from repro_torch.kernels.tune import KernelConfig


@pytest.fixture(autouse=True)
def _isolated_tuner(tmp_path, monkeypatch):
    """A tune cache of this test's own, and empty registries around it."""
    monkeypatch.setenv(tune.CACHE_PATH_ENV, str(tmp_path / "tune.json"))
    monkeypatch.delenv(tune.CACHE_ENV, raising=False)
    monkeypatch.delenv(tune.AUTOTUNE_ENV, raising=False)
    tune.clear()
    yield
    tune.clear()


def _geoms(G):
    """One geometry of each kind (and the packed cone pair's), built by
    package ``G``."""
    vol = G.VolumeGeometry(16, 20, 2)
    cone = G.cone_beam(12, 4, 40, vol, sod=80.0, sdd=160.0)
    return {
        "parallel": (G.parallel_beam(6, 2, 24, vol), False),
        "fan": (G.fan_beam(9, 2, 300, vol, sod=60.0, sdd=120.0), False),
        "cone": (cone, False),
        "cone-packed": (cone, True),
        "modular": (G.cone_as_modular(cone), False),
        "helical": (G.helical_beam(1.0, 8.0, 8, 10, 24,
                                   G.VolumeGeometry(16, 16, 8), sod=80.0,
                                   sdd=160.0), False),
    }


def _geom(**kw):
    return tgeo.parallel_beam(6, 2, 24, tgeo.VolumeGeometry(16, 16, 2), **kw)


@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("name", list(_geoms(tgeo)))
def test_shape_class_matches_the_reference(name, batch):
    jg, jpacked = _geoms(jgeo)[name]
    tg, tpacked = _geoms(tgeo)[name]
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jtune.shape_class(jg, batch, jdt, jpacked)
        assert tune.shape_class(tg, batch, tdt, tpacked) == want
    # dtype names and aliases spell the same class
    assert tune.shape_class(tg, batch, "bf16", tpacked) == \
        tune.shape_class(tg, batch, torch.bfloat16, tpacked)


def test_shape_class_buckets_not_exact_values():
    g1 = _geom()
    g2 = tgeo.parallel_beam(6, 2, 24, tgeo.VolumeGeometry(16, 16, 2),
                            angles=np.linspace(0.1, 2.0, 6))
    assert tune.shape_class(g1) == tune.shape_class(g2)
    g3 = tgeo.parallel_beam(6, 2, 500, tgeo.VolumeGeometry(16, 16, 2))
    assert tune.shape_class(g1) != tune.shape_class(g3)
    assert tune.shape_class(g1, 4) != tune.shape_class(g1, 5)
    assert tune.shape_class(g1, 5) == tune.shape_class(g1, 8)


def test_heuristic_by_pair_off_the_card():
    g = _geom()
    fan = _geoms(tgeo)["fan"][0]
    assert tune.get_config(g, 3, device="cpu") == tune.parallel_config(g, 3)
    assert tune.get_config(fan, 3, device="cpu") == tune.heuristic_config(fan, 3)
    # an explicit pin wins over everything
    pin = KernelConfig(bu=8, bg=32, lg=2)
    assert tune.resolve_config(g, 3, pin) is pin
    assert tune.resolve_config(g, 3, None, tune.parallel_config,
                               device="cpu") == tune.parallel_config(g, 3)


def test_register_config_overrides():
    g = _geom()
    pinned = KernelConfig(bu=8, bg=64, lg=2)
    tune.register_config(tune.shape_class(g), pinned)
    assert tune.get_config(g, device="cpu") is pinned
    assert tune.get_config(g, dtype=torch.bfloat16, device="cpu") is not pinned
    tune.clear()
    assert tune.get_config(g, device="cpu") == tune.parallel_config(g)


@pytest.mark.parametrize("name", list(_geoms(tgeo)))
def test_autotune_off_the_card_returns_the_heuristic_and_counts(name):
    g, packed = _geoms(tgeo)[name]
    heur = (tune.parallel_config if name == "parallel"
            else tune.heuristic_config)(g, 2)
    n0 = tune.sweep_count()
    cfg = tune.autotune(g, 2, packed=packed, device="cpu")
    assert cfg == heur and tune.sweep_count() == n0 + 1
    # kept under its shape class, and never written to disk
    assert tune.get_config(g, 2, packed=packed, device="cpu") is cfg
    assert not tune.cache_path().exists()
    assert tune.sweep_count() == n0 + 1


def test_get_config_sweeps_only_on_the_card(monkeypatch):
    """With autotuning on, a CPU tensor's resolution takes the heuristic
    without a sweep (the plain versions take no configuration)."""
    monkeypatch.setenv(tune.AUTOTUNE_ENV, "1")
    g = _geom()
    n0 = tune.sweep_count()
    assert tune.get_config(g, device="cpu") == tune.parallel_config(g)
    assert tune.get_config(g, device="cpu", autotune_flag=True) == \
        tune.parallel_config(g)
    assert tune.sweep_count() == n0


@pytest.mark.parametrize("name", ["parallel", "fan", "cone-packed"])
def test_entry_points_resolve_with_batch_dtype_and_pair(name, monkeypatch):
    """The lane-packed entry points resolve their configuration through
    get_config with the real batch, the tile dtype (the compute dtype) and
    the packed flag of the packed cone pair."""
    g, packed = _geoms(tgeo)[name]
    plan = {"parallel": fp_par.ParallelPlan, "fan": fp_fan.FanPlan,
            "cone-packed": fp_fan.ConePackedPlan}[name](g)
    fp, bp = ((fp_par.fp_parallel_sf, fp_par.bp_parallel_sf)
              if name == "parallel" else (fp_fan.fp_fan_sf, fp_fan.bp_fan_sf))
    seen = []
    orig = tune.get_config

    def spy(geom, batch=1, dtype=torch.float32, autotune_flag=None,
            packed=False, device=None):
        seen.append((batch, tune._dtype_name(dtype), packed, str(device)))
        return orig(geom, batch, dtype, autotune_flag, packed, device)

    monkeypatch.setattr(tune, "get_config", spy)
    x = torch.rand((3,) + g.vol.shape)
    y = torch.rand((3,) + g.sino_shape)
    fp(x, plan)
    bp(y, plan, compute_dtype="bf16")
    fp(x[0], plan, config=KernelConfig())          # a pin resolves nothing
    assert seen == [(3, "float32", packed, "cpu"), (3, "bfloat16", packed, "cpu")]


def test_default_candidates_fit_the_card_and_the_lanes():
    g = _geom()                                    # 2 rows
    for batch, top in ((1, 1), (4, 1), (5, 2), (32, 8), (100, 16)):
        cand = list(tune.default_candidates(g, batch))
        assert {c.lg for c in cand} == {1 << i for i in range(top.bit_length())}
        assert all(max(c.bu, c.bg) * c.lg <= 1024 for c in cand)
        assert {c.bu for c in cand if c.lg == 1} == set(tune._BUS)
        assert {c.bg for c in cand if c.lg == 1} == set(tune._BGS)


# --------------------------------------------------------------------------- #
# Disk cache (REPRO_TORCH_TUNE_CACHE_PATH points at tmp in every test here)
# --------------------------------------------------------------------------- #
def test_tune_cache_roundtrip(tmp_path, monkeypatch):
    path = tmp_path / "other" / "tune.json"
    monkeypatch.setenv(tune.CACHE_PATH_ENV, str(path))
    g = _geom()
    key = tune.shape_class(g)
    cfg = KernelConfig(bu=32, bg=64, lg=2)
    tune.save_tuned(key, cfg, "cpu")
    assert path.exists() and tune.cache_path() == path
    assert [p.name for p in path.parent.iterdir()] == ["tune.json"]
    assert tune.load_tuned(key, "cpu") == cfg
    # a fresh process (empty registries) reads it back without a sweep
    tune.clear()
    n0 = tune.sweep_count()
    assert tune.get_config(g, device="cpu") == cfg
    assert tune.sweep_count() == n0
    # keyed by shape class: another class misses
    g2 = tgeo.parallel_beam(6, 2, 500, tgeo.VolumeGeometry(16, 16, 2))
    assert tune.load_tuned(tune.shape_class(g2), "cpu") is None
    # a second save keeps the first entry
    tune.save_tuned(tune.shape_class(g2), KernelConfig(bu=16), "cpu")
    assert tune.load_tuned(key, "cpu") == cfg


def test_tune_cache_default_path(monkeypatch, tmp_path):
    monkeypatch.delenv(tune.CACHE_PATH_ENV)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tune.cache_path() == tmp_path / ".cache" / "repro_torch" / "tune.json"


def test_tune_cache_escape_hatch(monkeypatch):
    monkeypatch.setenv(tune.CACHE_ENV, "0")
    key = tune.shape_class(_geom())
    tune.save_tuned(key, KernelConfig(bu=32), "cpu")
    assert not tune.cache_path().exists()             # writes disabled
    monkeypatch.setenv(tune.CACHE_ENV, "1")
    tune.save_tuned(key, KernelConfig(bu=32), "cpu")
    monkeypatch.setenv(tune.CACHE_ENV, "off")
    assert tune.load_tuned(key, "cpu") is None        # reads disabled too
    assert tune.get_config(_geom(), device="cpu") == tune.parallel_config(_geom())


def test_tune_cache_corrupt_or_stale_file_ignored():
    path = tune.cache_path()
    key = tune.shape_class(_geom())
    path.write_text("{not json")
    assert tune.load_tuned(key, "cpu") is None
    # a stale schema (bad field values) is ignored, then overwritten cleanly
    path.write_text(json.dumps({tune._disk_key(key, "cpu"): {"bu": "huge"}}))
    assert tune.load_tuned(key, "cpu") is None
    path.write_text(json.dumps({tune._disk_key(key, "cpu"): {"bq": 3}}))
    assert tune.load_tuned(key, "cpu") is None
    path.write_text("[1, 2]")
    assert tune.load_tuned(key, "cpu") is None
    tune.save_tuned(key, KernelConfig(bu=16), "cpu")
    assert tune.load_tuned(key, "cpu") == KernelConfig(bu=16)


def test_tune_cache_keeps_cards_and_kernel_sources_apart(monkeypatch):
    """An entry measured on another card, or for other kernel sources, is
    not read back."""
    key = tune.shape_class(_geom())
    cfg = KernelConfig(bu=16, bg=32)
    tune.save_tuned(key, cfg, "cpu")
    disk = tune._disk_key(key, "cpu")
    assert disk.split("@")[1:] == ["cpu", tune._sources_hash()]
    data = json.loads(tune.cache_path().read_text())
    card = disk.replace("@cpu@", "@NVIDIA H100 80GB HBM3@")
    tune.cache_path().write_text(json.dumps({card: data[disk]}))
    assert tune.load_tuned(key, "cpu") is None
    tune.cache_path().write_text(json.dumps(data))
    assert tune.load_tuned(key, "cpu") == cfg
    monkeypatch.setattr(tune, "_sources_hash", lambda: "0" * 16)
    assert tune.load_tuned(key, "cpu") is None


def test_tune_cache_sees_another_writer():
    """The parsed file is kept per (path, mtime): a file rewritten by
    another process is read again."""
    key = tune.shape_class(_geom())
    tune.save_tuned(key, KernelConfig(bu=16), "cpu")
    assert tune.load_tuned(key, "cpu") == KernelConfig(bu=16)
    path = tune.cache_path()
    data = json.loads(path.read_text())
    data[tune._disk_key(key, "cpu")]["bu"] = 64
    st = path.stat()
    path.write_text(json.dumps(data))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    assert tune.load_tuned(key, "cpu") == KernelConfig(bu=64)


def test_sweep_keeps_the_fastest_measured_pair(monkeypatch):
    """The whole sweep on the host with a stand-in timer: candidates the
    plan's layouts refuse are never launched, the lg whose best FP plus
    best BP is least wins, and the winner is kept in the process and on
    disk (a CPU tensor runs the plain versions, so only the control flow
    is exercised here; the card tests time the kernels)."""
    g = tgeo.parallel_beam(8, 4, 24, tgeo.VolumeGeometry(12, 12, 4))
    batch = 9                                       # 36 lanes: lg 1-8
    rng = np.random.default_rng(0)
    launched = []
    orig_fp, orig_layout = fp_par.fp_lanes, fp_par.ParallelPlan.fp_layout

    def fp_lanes(x, plan, cfg):
        launched.append(cfg.bu)
        return orig_fp(x, plan, cfg)

    def fp_layout(self, grp, dtype, cfg):
        if cfg.bu == 64:
            raise ValueError("too much shared memory")
        return orig_layout(self, grp, dtype, cfg)

    monkeypatch.setattr(fp_par, "fp_lanes", fp_lanes)
    monkeypatch.setattr(fp_par.ParallelPlan, "fp_layout", fp_layout)
    monkeypatch.setattr(tune, "_can_sweep", lambda dev: True)
    monkeypatch.setattr(tune, "_event_ms",
                        lambda fn, reps: (fn(), float(rng.uniform(1, 2)))[1])
    n0 = tune.sweep_count()
    cfg = tune.autotune(g, batch, device="cpu")
    rec = tune.last_sweep()
    assert tune.sweep_count() == n0 + 1
    assert 64 not in launched and all(bu != 64 for _, bu in rec["fp_ms"])
    assert {lg for lg, _ in rec["fp_ms"]} == {1, 2, 4, 8}
    best = min((min(v for (l, _), v in rec["fp_ms"].items() if l == lg)
                + min(v for (l, _), v in rec["bp_ms"].items() if l == lg), lg)
               for lg in (1, 2, 4, 8))
    assert rec["tuned_ms"] == best[0] and cfg.lg == best[1]
    assert rec["fp_ms"][(cfg.lg, cfg.bu)] + rec["bp_ms"][(cfg.lg, cfg.bg)] == best[0]
    heur = tune.parallel_config(g, batch)
    assert rec["heuristic"] == heur and rec["heuristic_ms"] == \
        rec["fp_ms"][(heur.lg, heur.bu)] + rec["bp_ms"][(heur.lg, heur.bg)]
    key = tune.shape_class(g, batch)
    assert rec["key"] == key and tune.load_tuned(key, "cpu") == cfg
    assert tune.get_config(g, batch, device="cpu") is cfg
    # nothing measurable: the heuristic, kept in the process only
    monkeypatch.setattr(fp_par.ParallelPlan, "bp_layout",
                        lambda self, cfg: (_ for _ in ()).throw(ValueError()))
    tune.clear()
    g2 = tgeo.parallel_beam(8, 4, 40, tgeo.VolumeGeometry(12, 12, 4))
    assert tune.autotune(g2, batch, device="cpu") == tune.parallel_config(g2, batch)
    assert tune.load_tuned(tune.shape_class(g2, batch), "cpu") is None
    assert tune.last_sweep()["tuned"] is None


def test_resolution_is_memoized_per_class_and_device(monkeypatch):
    """A class with no entry resolves to the heuristic once: the disk is
    read once a class and device, a file written later by another process
    does not move a running process's config, and clear() or save_tuned()
    drop the memo."""
    g = _geom()
    reads = []
    orig = tune.load_tuned
    monkeypatch.setattr(tune, "load_tuned",
                        lambda key, dev=None: reads.append(key) or orig(key, dev))
    heur = tune.parallel_config(g)
    assert [tune.get_config(g, device="cpu") for _ in range(3)] == [heur] * 3
    assert len(reads) == 1
    key = tune.shape_class(g)
    other = KernelConfig(bu=8, bg=32, lg=1)
    tune.cache_path().write_text(json.dumps(
        {tune._disk_key(key, "cpu"): {"bu": 8, "bg": 32, "lg": 1}}))
    assert tune.get_config(g, device="cpu") == heur and len(reads) == 1
    tune.clear()
    assert tune.get_config(g, device="cpu") == other and len(reads) == 2
    g2 = tgeo.parallel_beam(6, 2, 500, tgeo.VolumeGeometry(16, 16, 2))
    assert tune.get_config(g2, device="cpu") == tune.parallel_config(g2)
    tune.save_tuned(tune.shape_class(g2), KernelConfig(bu=16), "cpu")
    assert tune.get_config(g2, device="cpu") == KernelConfig(bu=16)


def test_resolve_config_takes_only_the_pairs_heuristic():
    """The heuristic an entry point names is the one get_config falls back
    to for its geometry (one source of truth)."""
    g = _geom()
    fan = _geoms(tgeo)["fan"][0]
    assert tune.resolve_config(fan, 2, None, tune.heuristic_config,
                               device="cpu") == tune.heuristic_config(fan, 2)
    with pytest.raises(ValueError, match="heuristic"):
        tune.resolve_config(g, 2, None, tune.heuristic_config, device="cpu")
    with pytest.raises(ValueError, match="heuristic"):
        tune.resolve_config(fan, 2, None, tune.parallel_config, device="cpu")

"""Launch configuration of the CUDA projector kernels: heuristics, registry,
autotuner and its disk cache.

The lane-packed kernels (parallel and fan beam) carry 8 or 16 consecutive
lanes per thread (a lane is one ``batch x detector-row`` column of the
lane-packed layout, contiguous in memory; ``LANES_PER_THREAD`` is a lane
group, 16 from 4 groups a block on), and the threads of a block's lane
chunk share each footprint weight.  Both pairs read the fields as their
tile shape and derive the rest from the shapes:

    lg   groups of 8 lanes a block (the lane chunk: 8 lg lanes, whose
         threads share each weight; a thread carries 16 lanes from 4
         groups on, else 8).  The BP rounds it down to a power of two, at
         most 64 (a voxel's threads share a warp)
    bu   FP: detector columns a block (the tile whose weights are
         evaluated once and whose volume is staged).  The parallel layout
         adds up to ``fp_par.FP_VIEWS`` neighbouring views a block
         (``fp_par.ParallelPlan.fp_layout``); the fan layout walks the
         tile's loop lines in pieces of voxels that fill its shared memory
         budget (``fp_fan.FanPlan.fp_layout``)
    bg   BP: voxels a block, rounded down to whole warps and split into
         the squarest power-of-two tile of gi x li (``fp_par.bp_block``)

The fan pair's heuristic is :func:`heuristic_config` (also the packed cone
pair's: the fan kernels on a ``fp_fan.ConePackedPlan``), the parallel
pair's :func:`parallel_config`.  The exact cone and modular kernels have no
lane axis and take no configuration: their launches (``csrc/cone_sf.cuh``
``sf_grid``) derive the block from the detector rows or z slices, and the
samples per thread from the batch (``fp_cone.samples_per_thread``).

The kernels read 16 bytes at a time, and their wrappers pad the lane axis
to a multiple of 16 bytes where it is not one (``fp_par._aligned``).

**Resolution.**  The kernel entry points resolve a configuration through
:func:`resolve_config`: an explicit pin wins, else :func:`get_config`:

    1. an entry pinned for the shape class (:func:`register_config`), else
    2. one measured in this process (:func:`autotune`), else
    3. one measured earlier and kept in the disk cache, else
    4. a sweep (:func:`autotune`), on a CUDA device with autotuning
       enabled (``REPRO_TORCH_AUTOTUNE=1`` or ``autotune_flag=True``), else
    5. the pair's heuristic.

Configurations are keyed by a coarse *shape class* (:func:`shape_class`),
not the exact geometry: one sweep serves every geometry of the same
regime.  The lane-packed pairs are the only ones with a knob, so a sweep
covers the parallel pair, the fan pair and the packed cone pair; it times
each candidate's FP and BP with CUDA events after one warm-up launch,
after the plan's own layout checks have accepted it (a candidate whose
block cannot fit the card's shared memory is never launched).
:func:`sweep_count` counts every :func:`autotune` call: a warmed server
must answer its traffic without one.

**Disk cache.**  Measured configurations persist to
``~/.cache/repro_torch/tune.json`` (``REPRO_TORCH_TUNE_CACHE_PATH``
overrides the path; ``REPRO_TORCH_TUNE_CACHE=0`` turns reads and writes
off), keyed by the shape class, the card's name and the hash of the kernel
sources (``build._sources_hash``): a configuration measured on another
card, or for an earlier design of the kernels, is not read back.

:func:`packed_cone_ok` is the ``mode="auto"`` gate of the packed cone pair
(``kernels/ops.py``): the packed pair's worst axial footprint displacement
(``fp_cone.cone_packed_row_shift``) at most :func:`packed_cone_tolerance`
detector rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import pathlib
import statistics
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.geometry import CTGeometry
from repro_torch.kernels import precision

__all__ = ["KernelConfig", "LANES_PER_THREAD", "PACKED_CONE_DEFAULT_TOL",
           "autotune", "cache_path", "clear", "default_candidates",
           "get_config", "heuristic_config", "last_sweep", "load_tuned",
           "packed_cone_ok", "packed_cone_tolerance", "parallel_config",
           "register_config", "resolve_config", "save_tuned", "shape_class",
           "sweep_count"]

LANES_PER_THREAD = 8        # lanes a group (the kernels' lane vectors)
_THREADS = 128              # threads per block chosen by the heuristics
_MAX_THREADS = 1024
_MAX_GROUPS = 16            # lane groups a block, parallel heuristic
_FAN_MAX_GROUPS = 8         # lane groups a block, fan heuristic

AUTOTUNE_ENV = "REPRO_TORCH_AUTOTUNE"
CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
CACHE_PATH_ENV = "REPRO_TORCH_TUNE_CACHE_PATH"


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Block shapes of the lane-packed SF kernel pairs."""

    bu: int = 128    # FP detector columns per block
    bg: int = 128    # BP gathered voxels per block
    lg: int = 1      # lane groups per block (both kernels)

    def __post_init__(self):
        for name in ("bu", "bg", "lg"):
            v = getattr(self, name)
            if not (isinstance(v, int) and v > 0):
                raise ValueError(f"KernelConfig.{name} must be a positive "
                                 f"int, got {v!r}")
        if max(self.bu, self.bg) * self.lg > _MAX_THREADS:
            raise ValueError(
                f"KernelConfig{(self.bu, self.bg, self.lg)} asks for more "
                f"than {_MAX_THREADS} threads per block")

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def heuristic_config(geom: CTGeometry, batch: int = 1) -> KernelConfig:
    """The fan kernels' heuristic: as many lane groups as the lanes need,
    up to 8 (a thread carries 8 lanes, or 16 from 4 groups on; the FP
    stages a voxel's whole lane chunk, so wider chunks leave fewer voxels
    a piece), and blocks of 128 threads: FP tiles of 128 columns at one
    thread a column, fewer as the lane chunk widens; BP blocks likewise
    (PERF.md, the fan pair's sweeps)."""
    lanes = batch * geom.n_rows
    groups = -(-lanes // LANES_PER_THREAD)
    lg = min(_pow2_ceil(groups), _FAN_MAX_GROUPS)
    tl = lg if lg < 4 else lg // 2          # threads an output
    return KernelConfig(bu=_THREADS // tl, bg=_THREADS // tl, lg=lg)


# The parallel kernels' heuristic, chosen from sweeps on the H100 (PERF.md): a
# lane chunk of up to 16 groups (128 lanes: each weight serves them all);
# FP tiles of 32 columns at 8 lanes, else 16 (with up to FP_VIEWS views a
# block, fp_par.ParallelPlan.fp_layout); BP blocks of 128 threads.


def parallel_config(geom: CTGeometry, batch: int = 1) -> KernelConfig:
    """The parallel kernels' heuristic: as many lane groups as the lanes
    need, up to 16 (a thread carries 8 lanes, or 16 from 4 groups on:
    ``fp_par._lanes_per_thread``); the FP's tile and the BP's block as
    above."""
    lanes = batch * geom.n_rows
    groups = -(-lanes // LANES_PER_THREAD)
    lg = min(_pow2_ceil(groups), _MAX_GROUPS)
    tl = lg if lg < 4 else lg // 2          # threads an output
    return KernelConfig(bu=32 if tl == 1 else 16, bg=128 // tl, lg=lg)


def _heuristic(geom: CTGeometry) -> Callable[[CTGeometry, int], KernelConfig]:
    return parallel_config if geom.geom_type == "parallel" else heuristic_config


# --------------------------------------------------------------------------- #
# Shape classes
# --------------------------------------------------------------------------- #
def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return precision.normalize(dtype) or "float32"


def shape_class(geom: CTGeometry, batch: int = 1, dtype=torch.float32,
                packed: bool = False) -> Tuple:
    """Coarse key of a kernel-tuning regime, the reference package's tuple:
    the kind (``"-packed"`` marks the packed cone pair, whose kernels are
    the fan pair's), and the transaxial volume size, the detector columns,
    the views and the lanes ``batch * n_rows``, each rounded up to a power
    of two, and the dtype's name.  Exact geometry values (angles, pitches,
    shifts) are left out: they do not move the best blocks."""
    return (geom.geom_type + ("-packed" if packed else ""),
            _pow2_ceil(max(geom.vol.nx, geom.vol.ny)),
            _pow2_ceil(geom.n_cols),
            _pow2_ceil(geom.n_angles),
            _pow2_ceil(batch * geom.n_rows),
            _dtype_name(dtype))


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #
_REGISTRY: Dict[Tuple, KernelConfig] = {}       # pinned entries
_AUTOTUNED: Dict[Tuple, KernelConfig] = {}      # measured (or read) entries
_RESOLVED: Dict[Tuple, KernelConfig] = {}       # (class, device): no entry
_SWEEPS = 0                                     # autotune() calls
_LAST_SWEEP: Dict = {}


def sweep_count() -> int:
    """:func:`autotune` calls in this process (the warm-path probe: a
    primed server must answer traffic without one)."""
    return _SWEEPS


def last_sweep() -> Dict:
    """The timings of the last sweep that measured: its shape class
    (``key``), the FP's ms by ``(lg, bu)`` (``fp_ms``) and the BP's by
    ``(lg, bg)`` (``bp_ms``), the ``heuristic`` and ``tuned``
    configurations and their pair times (FP + BP, ms)."""
    return dict(_LAST_SWEEP)


def register_config(cls_key: Tuple, cfg: KernelConfig) -> None:
    """Pin a configuration for a shape class (over the measured ones and
    the heuristics)."""
    _REGISTRY[cls_key] = cfg


def clear() -> None:
    """Drop the in-process registries (the disk cache stays)."""
    _REGISTRY.clear()
    _AUTOTUNED.clear()
    _RESOLVED.clear()
    _LAST_SWEEP.clear()


# --------------------------------------------------------------------------- #
# Disk cache
# --------------------------------------------------------------------------- #
def _env_on(name: str, default: str) -> bool:
    val = os.environ.get(name, default).strip().lower()
    return val not in ("", "0", "false", "no", "off")


def cache_path() -> pathlib.Path:
    """The disk cache's file (``REPRO_TORCH_TUNE_CACHE_PATH`` or
    ``~/.cache/repro_torch/tune.json``)."""
    p = os.environ.get(CACHE_PATH_ENV)
    if p:
        return pathlib.Path(p)
    return pathlib.Path.home() / ".cache" / "repro_torch" / "tune.json"


def _device(device=None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


@functools.lru_cache(maxsize=1)
def _sources_hash() -> str:
    from repro_torch.kernels import build
    return build._sources_hash()


def _disk_key(cls_key: Tuple, device=None) -> str:
    """The shape class, the card's name (``cpu`` off the card) and the
    kernel sources' hash."""
    dev = _device(device)
    if dev.type == "cuda":
        name = _card_name(torch.cuda.current_device() if dev.index is None
                          else dev.index)
    else:
        name = "cpu"
    return "|".join(str(x) for x in cls_key) + f"@{name}@{_sources_hash()}"


def save_tuned(cls_key: Tuple, cfg: KernelConfig, device=None) -> None:
    """Persist a measured configuration (best effort; nothing when the
    cache is off).  The file is replaced whole, so a reader never sees a
    partial write."""
    _RESOLVED.clear()
    if not _env_on(CACHE_ENV, "1"):
        return
    path = cache_path()
    try:
        data = json.loads(path.read_text()) if path.exists() else {}
        if not isinstance(data, dict):
            data = {}
    except (OSError, ValueError):
        data = {}
    data[_disk_key(cls_key, device)] = dataclasses.asdict(cfg)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(data, indent=2, sort_keys=True))
        os.replace(tmp, path)
    except OSError:
        pass


# The parsed file, keyed by (path, mtime_ns): load_tuned reads the cache on
# every call, and this keeps that to a stat.  A save (here or in another
# process) changes the mtime and so the key.
_DISK_MEMO: Dict[Tuple[str, int], dict] = {}


def _read_disk_cache() -> dict:
    path = cache_path()
    try:
        mtime = path.stat().st_mtime_ns
    except OSError:
        return {}
    memo_key = (str(path), mtime)
    if memo_key not in _DISK_MEMO:
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError):
            data = {}
        _DISK_MEMO.clear()
        _DISK_MEMO[memo_key] = data if isinstance(data, dict) else {}
    return _DISK_MEMO[memo_key]


def load_tuned(cls_key: Tuple, device=None) -> Optional[KernelConfig]:
    """The persisted configuration of this shape class on this card and
    kernel sources, or None (also for an entry of a stale or foreign
    schema)."""
    if not _env_on(CACHE_ENV, "1"):
        return None
    data = _read_disk_cache()
    if not data:
        return None
    raw = data.get(_disk_key(cls_key, device))
    if not isinstance(raw, dict):
        return None
    try:
        return KernelConfig(**{k: int(v) for k, v in raw.items()})
    except (TypeError, ValueError):
        return None


# --------------------------------------------------------------------------- #
# Resolution
# --------------------------------------------------------------------------- #
def get_config(geom: CTGeometry, batch: int = 1, dtype=torch.float32,
               autotune_flag: Optional[bool] = None, packed: bool = False,
               device=None) -> KernelConfig:
    """The configuration for ``geom`` at ``batch`` lanes of ``dtype`` tiles
    on ``device`` (None: the card where there is one), in the module
    docstring's order.

    A shape class that resolves to no entry (a miss in the registries and
    on disk, with no sweep) is memoized per device with the pair's
    heuristic: the entry points resolve on every call, and the disk is
    read once a class, so a file rewritten by another process does not
    change a running process's kernels (:func:`clear` and
    :func:`save_tuned` drop the memo)."""
    key = shape_class(geom, batch, dtype, packed)
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key in _AUTOTUNED:
        return _AUTOTUNED[key]
    dev = _device(device)
    sweep = _can_sweep(dev) and (autotune_flag if autotune_flag is not None
                                 else _env_on(AUTOTUNE_ENV, "0"))
    memo = (key, str(dev))
    if memo in _RESOLVED and not sweep:
        return _RESOLVED[memo]
    disk = load_tuned(key, dev)
    if disk is not None:
        _AUTOTUNED[key] = disk
        return disk
    if sweep:
        return autotune(geom, batch, dtype, packed=packed, device=dev)
    cfg = _RESOLVED[memo] = _heuristic(geom)(geom, batch)
    return cfg


def resolve_config(
        geom: CTGeometry, batch: int, config: Optional[KernelConfig],
        heuristic: Callable[[CTGeometry, int], KernelConfig] = heuristic_config,
        dtype=torch.float32, packed: bool = False, device=None,
) -> KernelConfig:
    """An explicit ``config`` wins, else :func:`get_config` for tiles of
    ``dtype`` on ``device``.  ``heuristic`` names the calling pair's
    heuristic (the fan pair's :func:`heuristic_config`, or the parallel
    pair's :func:`parallel_config`); it must be the one
    :func:`get_config` falls back to for ``geom``."""
    if config is not None:
        return config
    if heuristic is not _heuristic(geom):
        raise ValueError(f"{heuristic.__name__} is not the heuristic of a "
                         f"{geom.geom_type} geometry")
    return get_config(geom, batch, dtype, packed=packed, device=device)


# --------------------------------------------------------------------------- #
# Packed-cone dispatch gate
# --------------------------------------------------------------------------- #
# Default ceiling on the packed approximation's worst-case axial footprint
# displacement (detector rows).  A quarter row keeps the relative error bound
# (2x the shift + the second-order obliquity term, see
# fp_cone.cone_packed_error_bound) well below typical detector noise.
PACKED_CONE_DEFAULT_TOL = 0.25
PACKED_CONE_TOL_ENV = "REPRO_TORCH_PACKED_CONE_TOL"


def packed_cone_tolerance() -> float:
    """Row-shift ceiling for ``mode="auto"`` packed-cone dispatch
    (``REPRO_TORCH_PACKED_CONE_TOL`` overrides the default; a value that is
    not a float raises, rather than dispatching the approximate pair at a
    gate the user did not ask for)."""
    val = os.environ.get(PACKED_CONE_TOL_ENV, "").strip()
    if val:
        try:
            return float(val)
        except ValueError:
            raise ValueError(
                f"{PACKED_CONE_TOL_ENV}={val!r} is not a float") from None
    return PACKED_CONE_DEFAULT_TOL


def packed_cone_ok(geom: CTGeometry) -> bool:
    """True when the packed (lane-packed, axial pre-resample) cone pair is
    within tolerance for this geometry: the ``mode="auto"`` gate."""
    if geom.geom_type != "cone" or geom.detector_type != "flat":
        return False
    from repro_torch.kernels import fp_cone            # late: fp_cone imports us
    return fp_cone.cone_packed_row_shift(geom) <= packed_cone_tolerance()


# --------------------------------------------------------------------------- #
# Autotuner
# --------------------------------------------------------------------------- #
_BUS = (8, 16, 32, 64, 128)            # FP columns a block
_BGS = (32, 64, 128, 256, 512)         # BP voxels a block


def default_candidates(geom: CTGeometry, batch: int = 1
                       ) -> Iterable[KernelConfig]:
    """The sweep's grid: lane chunks of 1 group up to the lanes' need (at
    most 16), each with FP tiles of 8-128 columns and BP blocks of 32-512
    voxels, within 1024 threads a block."""
    groups = -(-batch * geom.n_rows // LANES_PER_THREAD)
    top = min(_pow2_ceil(groups), _MAX_GROUPS)
    lgs = [1 << i for i in range(top.bit_length())]
    for lg, bu, bg in itertools.product(lgs, _BUS, _BGS):
        if max(bu, bg) * lg <= _MAX_THREADS:
            yield KernelConfig(bu=bu, bg=bg, lg=lg)


def _sweep_plan(geom: CTGeometry, packed: bool):
    """The lane plan whose kernels take a configuration, or None (the exact
    cone and modular pairs)."""
    from repro_torch.kernels import fp_fan, fp_par    # late: they import us
    if geom.geom_type == "parallel":
        return fp_par.ParallelPlan(geom)
    if geom.geom_type == "fan":
        return fp_fan.FanPlan(geom)
    if geom.geom_type == "cone" and packed:
        return fp_fan.ConePackedPlan(geom)
    return None


def _can_sweep(dev: torch.device) -> bool:
    """Whether a sweep can time kernels on ``dev`` (a CUDA device: a CPU
    tensor runs the plain versions, which take no configuration)."""
    return dev.type == "cuda"


def _fits(layout: Callable[[], object]) -> bool:
    """Whether the plan's host-side layout check accepts a candidate (it
    raises ``ValueError`` for a block that cannot fit the card)."""
    try:
        layout()
    except ValueError:
        return False
    return True


def _event_ms(fn, reps: int) -> float:
    """Median device ms of ``fn()`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _sweep(plan, cand, dtype: torch.dtype, lanes: int, dev: torch.device,
           reps: int) -> Tuple[Dict, Dict]:
    """The FP's ms by ``(lg, bu)`` and the BP's by ``(lg, bg)`` of the
    candidates ``cand`` that the plan's layouts accept, on tiles of ones."""
    from repro_torch.kernels import fp_par            # late: it imports us
    geom = plan.geom
    groups = [grp for grp in (0, 1) if plan.tables[grp].shape[0]]
    g = torch.ones((geom.vol.nx, geom.vol.ny, lanes), dtype=dtype, device=dev)
    q = torch.ones((geom.n_angles, geom.n_cols, lanes), dtype=dtype,
                   device=dev)
    fp_ms: Dict[Tuple[int, int], float] = {}
    bp_ms: Dict[Tuple[int, int], float] = {}
    for lg, bu in sorted({(c.lg, c.bu) for c in cand}):
        cfg = KernelConfig(bu=bu, bg=bu, lg=lg)
        if all(_fits(lambda grp=grp: plan.fp_layout(grp, dtype, cfg))
               for grp in groups):
            fp_ms[(lg, bu)] = _event_ms(
                lambda: fp_par.fp_lanes(g, plan, cfg), reps)
    for lg, bg in sorted({(c.lg, c.bg) for c in cand}):
        cfg = KernelConfig(bu=bg, bg=bg, lg=lg)
        if _fits(lambda: plan.bp_layout(cfg)):
            bp_ms[(lg, bg)] = _event_ms(
                lambda: fp_par.bp_lanes(q, plan, cfg), reps)
    return fp_ms, bp_ms


def _pick(fp_ms: Dict, bp_ms: Dict) -> Optional[Tuple[float, KernelConfig]]:
    """The pair time and configuration of the ``lg`` whose best FP plus
    best BP is least (None: no ``lg`` has both measured)."""
    best = None
    for lg in sorted({lg for lg, _ in fp_ms} & {lg for lg, _ in bp_ms}):
        bu = min((b for k, b in fp_ms if k == lg), key=lambda b: fp_ms[(lg, b)])
        bg = min((b for k, b in bp_ms if k == lg), key=lambda b: bp_ms[(lg, b)])
        t = fp_ms[(lg, bu)] + bp_ms[(lg, bg)]
        if best is None or t < best[0]:
            best = (t, KernelConfig(bu=bu, bg=bg, lg=lg))
    return best


def autotune(geom: CTGeometry, batch: int = 1, dtype=torch.float32,
             candidates: Optional[Iterable[KernelConfig]] = None,
             reps: int = 3, packed: bool = False,
             device=None) -> KernelConfig:
    """Time the candidates (:func:`default_candidates`, and the heuristic)
    on the kernels and keep the fastest pair, in this process and on disk.

    The FP and the BP share ``lg``: for each ``lg`` the FP is timed over
    ``bu`` and the BP over ``bg``, and the ``lg`` whose best FP plus best
    BP is least wins.  Only candidates that the plan's layouts accept are
    launched, and a candidate that was not measured is never kept on disk.
    Off the card this returns the heuristic without timing (a CPU tensor
    runs the plain versions, which take no configuration), and so does a
    geometry whose kernels take none (the exact cone and modular pairs:
    ``csrc/cone_sf.cuh`` ``sf_grid`` derives their blocks).  Every call
    counts in :func:`sweep_count`."""
    global _SWEEPS
    _SWEEPS += 1
    key = shape_class(geom, batch, dtype, packed)
    heur = _heuristic(geom)(geom, batch)
    dev = _device(device)
    plan = _sweep_plan(geom, packed) if _can_sweep(dev) else None
    if plan is None:
        _AUTOTUNED[key] = heur
        return heur
    cand = list(default_candidates(geom, batch) if candidates is None
                else candidates) + [heur]
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        fp_ms, bp_ms = _sweep(plan, cand, getattr(torch, _dtype_name(dtype)),
                              batch * geom.n_rows, dev, reps)
    best = _pick(fp_ms, bp_ms)
    hfp, hbp = (heur.lg, heur.bu), (heur.lg, heur.bg)
    _LAST_SWEEP.clear()
    _LAST_SWEEP.update(
        key=key, fp_ms=fp_ms, bp_ms=bp_ms, heuristic=heur,
        heuristic_ms=(fp_ms[hfp] + bp_ms[hbp]
                      if hfp in fp_ms and hbp in bp_ms else None),
        tuned=None if best is None else best[1],
        tuned_ms=None if best is None else best[0])
    if best is None:                  # nothing measured: keep the heuristic
        _AUTOTUNED[key] = heur
        return heur
    _AUTOTUNED[key] = best[1]
    save_tuned(key, best[1], dev)
    return best[1]

"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use, with ``nvcc`` alone, into
a shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/repro_torch/<name>-<hash>.so
         csrc/<name>.cu

The output lands in ``build/repro_torch/`` at the root of the checkout
(git-ignored), named by a hash of every source under ``csrc/`` so that a
stale library is never loaded, with nvcc's output beside it
(``<name>-<hash>.log``: ptxas's registers, spills and shared memory of
every kernel, read by :func:`ptxas_report`).  A variant of a library is
the same source built with more flags into ``<name>-<variant>-<hash>.so``:
``"phases"`` compiles in the cone-family FP's and BP's phase profiles
(``-DSF_FP_PHASES``, ``-DSF_BP_PHASES``, csrc/cone_sf.cuh), which the
kernels the port runs never carry.  Without ``nvcc`` this raises: there
is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Any, Dict, Iterable, List, Tuple

__all__ = ["build_all", "library", "loaded", "parse_ptxas", "ptxas_report",
           "BUILD_DIR", "CSRC"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# extra nvcc flags by variant ("" is the library the port runs)
VARIANTS = {"": [], "phases": ["-DSF_FP_PHASES", "-DSF_BP_PHASES"]}

_LIBS: Dict[Tuple[str, str], ctypes.CDLL] = {}
_LOCK = threading.Lock()

_c = ctypes
# argtypes of every C entry point, by library.  Pointers and the stream are
# c_void_p so that 64-bit addresses are never cut to 32 bits.
_SIGNATURES = {
    # the parallel pair: the lane-packed head, then the layouts of
    # fp_par.ParallelPlan.fp_layout (view batches and their count, tu, tl,
    # lpt, nvb, lch, wcap, kw) and bp_layout (accumulate, bx, by, tl, lpt,
    # ku); the info entry points: (dtype, the FP's layout or lpt, threads
    # and ku; out shared bytes, out blocks per SM)
    "fp_par": {
        "fp_par_sf_launch": [
            _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_void_p,
            _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_longlong,
            _c.c_longlong, _c.c_int, _c.c_float, _c.c_float, _c.c_void_p]
        + [_c.c_int] * 8 + [_c.c_void_p],
        "bp_par_sf_launch": [
            _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_void_p,
            _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_longlong,
            _c.c_longlong, _c.c_int, _c.c_float, _c.c_float] + [_c.c_int] * 6
        + [_c.c_void_p],
        "fp_par_sf_info": [_c.c_int] * 8 + [_c.POINTER(_c.c_int)] * 2,
        "bp_par_sf_info": [_c.c_int] * 4 + [_c.POINTER(_c.c_int)] * 2,
    },
    # the fan pair: the lane-packed head, then (sdd, dxv, hw, curved) and
    # the layout of fp_fan.FanPlan.fp_layout (tu, tl, lpt, vcap, segs, ku),
    # or (sdd, dxv, curved) and bp_layout (accumulate, bx, by, tl, lpt,
    # ku); the info entry points: (dtype, curved, the FP's layout with nl,
    # or lpt, threads, nu and ku; out shared bytes, out blocks per SM); the
    # division check: (seed, pairs, device counter, stream)
    "fp_fan": {
        "fp_fan_sf_launch": [
            _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_void_p,
            _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_longlong,
            _c.c_longlong, _c.c_int, _c.c_float, _c.c_float, _c.c_float,
            _c.c_float, _c.c_float] + [_c.c_int] * 7 + [_c.c_void_p],
        "bp_fan_sf_launch": [
            _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_void_p,
            _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_longlong,
            _c.c_longlong, _c.c_int, _c.c_float, _c.c_float, _c.c_float,
            _c.c_float] + [_c.c_int] * 7 + [_c.c_void_p],
        "fp_fan_sf_info": [_c.c_int] * 9 + [_c.POINTER(_c.c_int)] * 2,
        "bp_fan_sf_info": [_c.c_int] * 6 + [_c.POINTER(_c.c_int)] * 2,
        "fp_fan_div_check": [_c.c_uint, _c.c_ulonglong, _c.c_void_p,
                             _c.c_void_p],
    },
    "fp_cone": {
        "fp_cone_sf_launch": [
            _c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int,
            _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_int,
            _c.c_longlong, _c.c_longlong, _c.c_int, _c.c_int, _c.c_float,
            _c.c_float, _c.c_float, _c.c_float, _c.c_float, _c.c_float,
            _c.c_float, _c.c_float, _c.c_float, _c.c_int, _c.c_int,
            _c.c_int, _c.c_int, _c.c_void_p],
        "bp_cone_sf_launch": [
            _c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int,
            _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_int,
            _c.c_longlong, _c.c_longlong, _c.c_int, _c.c_int, _c.c_float,
            _c.c_float, _c.c_float, _c.c_float, _c.c_float, _c.c_float,
            _c.c_float, _c.c_float, _c.c_int, _c.c_int, _c.c_void_p],
    },
}
# The flash kernels: (dtype, hd[, stats]), the tensors, a host array of
# (batch, head, sequence) strides, (B, H, KV, S, window, scale), the stream.
_LL = _c.POINTER(_c.c_longlong)
_FLASH_TAIL = [_LL, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
               _c.c_float, _c.c_void_p]
_SIGNATURES["flash"] = {
    "flash_fwd_launch": [_c.c_int, _c.c_int, _c.c_int] + [_c.c_void_p] * 5
    + _FLASH_TAIL,
    "flash_bwd_dq_launch": [_c.c_int, _c.c_int] + [_c.c_void_p] * 7
    + _FLASH_TAIL,
    "flash_bwd_dkv_launch": [_c.c_int, _c.c_int] + [_c.c_void_p] * 8
    + _FLASH_TAIL,
    "flash_info": [_c.c_int, _c.c_int, _c.c_int, _c.POINTER(_c.c_int)],
}
# The FP's shared bytes and blocks per SM at a layout: (dtype, spt, tv,
# ncap, smax, emax, out bytes, out blocks).
_SIGNATURES["fp_cone"]["fp_cone_sf_info"] = [
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
    _c.POINTER(_c.c_int), _c.POINTER(_c.c_int)]
# The BP's blocks per SM: (dtype, spt, out blocks).
_SIGNATURES["fp_cone"]["bp_cone_sf_info"] = [_c.c_int, _c.c_int,
                                             _c.POINTER(_c.c_int)]
# The FP's division against __fdiv_rn: (dv, lo, hi, device counter, stream).
_SIGNATURES["fp_cone"]["fp_cone_div_check"] = [
    _c.c_float, _c.c_uint, _c.c_uint, _c.c_void_p, _c.c_void_p]
# The modular pair's entry points take the cone pair's arguments (sdd is the
# reference distance sdd_ref).
_SIGNATURES["fp_modular"] = {
    "fp_modular_sf_launch": _SIGNATURES["fp_cone"]["fp_cone_sf_launch"],
    "bp_modular_sf_launch": _SIGNATURES["fp_cone"]["bp_cone_sf_launch"],
    "fp_modular_sf_info": _SIGNATURES["fp_cone"]["fp_cone_sf_info"],
    "bp_modular_sf_info": _SIGNATURES["fp_cone"]["bp_cone_sf_info"],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels are built from source on "
        "first use and need the CUDA toolkit")


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str, variant: str = "") -> pathlib.Path:
    tag = f"{name}-{variant}" if variant else name
    return BUILD_DIR / f"{tag}-{_sources_hash()}.so"


def _compile(keys: List[Tuple[str, str]]) -> None:
    """Start one ``nvcc`` per (source, variant), all together, and wait for
    them."""
    todo = [k for k in keys if not _target(*k).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n, variant in todo:
        out = _target(n, variant)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *VARIANTS[variant], "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for n, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{log.decode(errors='replace')}")
            continue
        out.with_suffix(".log").write_bytes(log)
        os.replace(tmp, out)             # atomic against concurrent builds
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _load(name: str, variant: str = "") -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name, variant)))
    sigs = dict(_SIGNATURES[name])
    if variant == "phases":
        sigs[f"{name}_phases_read"] = [_c.c_void_p]
    for fn, argtypes in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(name: str, rc: int, what: str) -> None:
    """Raise when a C entry point of library ``name`` returned a CUDA error."""
    if rc != 0:
        msg = getattr(library(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def build_all(extra: Iterable[Tuple[str, str]] = ()) -> None:
    """Build (where needed) and load every kernel library, and the
    (library, variant) pairs of ``extra``, with one nvcc each, all
    together."""
    with _LOCK:
        keys = [(n, "") for n in _SIGNATURES] + list(extra)
        keys = [k for k in keys if k not in _LIBS]
        _compile(keys)
        for k in keys:
            _LIBS[k] = _load(*k)


def parse_ptxas(log: str) -> Dict[str, Dict[str, Any]]:
    """ptxas's ``-v`` report on each kernel, by mangled name: ``registers``,
    ``stack`` (bytes a thread), ``spill_stores`` and ``spill_loads``
    (bytes), ``smem`` (static shared bytes; dynamic shared memory is set at
    launch), and, where ptxas gave any, ``notes``: its coded warnings, such
    as ``"C7508 ..."`` (setmaxnreg ignored) or ``"C7510 ..."`` to
    ``"C7520 ..."`` (wgmma serialized), each with its text.  A note belongs
    to the kernel it names, else to the kernel being compiled, else to
    ``""``."""
    report: Dict[str, Dict[str, Any]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = report.setdefault(m.group(1), {})
            continue
        m = re.search(r"\((C\d{4})\)\s*(.*)", line)
        if m:
            named = re.search(r"function '(\w+)'", line)
            owner = (report.setdefault(named.group(1), {}) if named
                     else cur if cur is not None
                     else report.setdefault("", {}))
            owner.setdefault("notes", []).append(
                f"{m.group(1)} {m.group(2).strip()}")
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return report


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """:func:`parse_ptxas` of library ``name``'s build log."""
    library(name)
    return parse_ptxas(_target(name).with_suffix(".log").read_text())


def loaded() -> List[Tuple[str, str]]:
    """The (library, variant) pairs loaded in this process, sorted: a warm
    server builds and loads none on its request path."""
    return sorted(_LIBS)


def library(name: str, variant: str = "") -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (as ``variant``,
    one of :data:`VARIANTS`)."""
    if (name, variant) not in _LIBS:
        build_all(() if not variant else [(name, variant)])
    return _LIBS[(name, variant)]

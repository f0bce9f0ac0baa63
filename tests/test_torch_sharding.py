"""The port's partition rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), and its layouts.

* For every leaf of all ten configs' parameter trees, on the mesh shapes
  (16, 16), (2, 16, 16) and (64, 4), with each config's default FSDP
  choice and with FSDP forced on and off: the port's spec
  (``param_specs``) equals the reference's ``param_pspec`` except the
  departures in ``DEPARTURES``, each with its reason.  The reference's
  rule needs only ``mesh.shape`` and ``mesh.axis_names``, so
  ``MeshShape`` serves as its mesh.
* ``cache_pspec`` and ``batch_pspec`` equal the reference's for every
  decode cache and input of the assigned shape sets; ``cache_specs`` (the
  port's layout) departs only as ``CACHE_DEPARTURES`` says.
* ``gather_params(shard_params(p))`` is bit-equal to ``p`` on gloo worlds
  of (2, 2) (with and without FSDP) and (1, 4), and a rank's Mamba
  ``in_proj`` holds its slices of ``x`` and of ``z``.
"""
import numpy as np
import pytest
import torch

from repro.launch import sharding as JSH

from repro_torch import configs
from repro_torch.launch import sharding as SH
from repro_torch.launch import shapes as TSH
from repro_torch.launch.mesh import MeshShape, run_world, tp_size
from repro_torch.models import model as MD

import torch_dist_worlds as W

MESHES = [(16, 16), (2, 16, 16), (64, 4)]
# leaf name -> (the config field whose count must divide by tp, why)
DEPARTURES = {
    "wq": ("n_heads", "tensor parallelism cannot split a head"),
    "wo": ("n_heads", "tensor parallelism cannot split a head"),
    "wk": ("n_kv_heads", "tensor parallelism cannot split a KV head"),
    "wv": ("n_kv_heads", "tensor parallelism cannot split a KV head"),
    "in_proj": ("d_inner", "[x | z] splits part by part, each by d_inner"),
}
# cache entry -> dims the port never splits where the reference may, why
CACHE_DEPARTURES = {
    "k": ({2: "no sequence on the data axes", 4: "no head-dim split"},
          "n_kv_heads"),
    "v": ({2: "no sequence on the data axes", 4: "no head-dim split"},
          "n_kv_heads"),
    "conv": ({}, "d_inner"), "ssm": ({}, "d_inner"),
}


def _norm(spec, nd=None):
    """A spec as plain entries, one a dim (``P()`` is every dim
    replicated): a one-axis tuple as its name (jax's PartitionSpec does the
    same)."""
    out = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                (tuple(e) if isinstance(e, tuple) else e) for e in spec)
    return out + (None,) * ((nd or len(out)) - len(out))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _expected(cfg, name, ref, tp):
    if name in DEPARTURES and getattr(cfg, DEPARTURES[name][0]) % tp:
        return tuple(None if e == "model" else e for e in ref)
    return ref


@pytest.mark.parametrize("fsdp", [None, False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_reference_but_the_departures(arch, shape, fsdp):
    cfg = configs.get(arch)
    mesh = MeshShape(shape)
    tp = tp_size(mesh)
    f = (cfg.n_params() > 3e9 or cfg.pure_dp) if fsdp is None else fsdp
    ours = dict(_leaves(SH.param_specs(cfg, MD.param_shapes(cfg), mesh, fsdp)))
    departed = []
    for path, shp in _leaves(MD.param_shapes(cfg)):
        ref = _norm(JSH.param_pspec(path, shp, mesh, f), len(shp))
        got = _norm(ours[path])
        assert got == _norm(_expected(cfg, path[-1], ref, tp)), (path, got, ref)
        if path[0] in ("layers", "embed", "head"):
            assert got[0] is None, path      # the layer / codebook axis
        if got != ref:
            departed.append(path[-1])
    assert set(departed) <= set(DEPARTURES)


def test_the_departures_occur_where_the_reference_splits_a_head():
    """The ones the docstring names: Hymba's wq (25 x 64) at tp 16 and
    Qwen3's wk (8 KV heads) at tp 16."""
    mesh = MeshShape((16, 16))
    for arch, leaf, ref_split in (("hymba-1.5b", "wq", True), ("qwen3-0.6b", "wk", True),
                                  ("qwen3-0.6b", "wq", True)):
        cfg = configs.get(arch)
        shp = MD.param_shapes(cfg)["layers"]["attn"][leaf]
        ref = JSH.param_pspec(("layers", "attn", leaf), shp, mesh, False)
        got = SH.param_specs(cfg, MD.param_shapes(cfg), mesh)["layers"]["attn"][leaf]
        assert ("model" in tuple(ref)) == ref_split
        assert ("model" in got) == (getattr(cfg, DEPARTURES[leaf][0]) % 16 == 0)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cache_and_batch_specs_match_reference(arch, shape):
    cfg = configs.get(arch)
    mesh = MeshShape(shape)
    tp = tp_size(mesh)
    for sname in ("decode_32k", "long_500k"):
        s = TSH.SHAPES[sname]
        shapes = {n: shp for n, (shp, _) in MD.cache_shapes(
            cfg, s.global_batch, s.seq_len).items()}
        ours = SH.cache_specs(cfg, shapes, mesh)
        for name, shp in shapes.items():
            ref = _norm(JSH.cache_pspec(name, shp, mesh))
            assert _norm(SH.cache_pspec(name, shp, mesh)) == ref
            dims, count = CACHE_DEPARTURES[name]
            want = list(ref)
            for d in dims:
                want[d] = None
            if getattr(cfg, count) % tp:
                want = [None if e == "model" else e for e in want]
            assert _norm(ours[name]) == tuple(want), (sname, name)
    for sname, s in TSH.SHAPES.items():
        for name, t in TSH.input_specs(cfg, s).items():
            if name == "cache":
                continue
            bd = 1 if name == "positions" else 0
            assert _norm(SH.batch_pspec(tuple(t.shape), mesh, bd)) == \
                _norm(JSH.batch_pspec(tuple(t.shape), mesh, bd)), (sname, name)


def test_local_shapes_of_a_rank():
    cfg = configs.get("qwen3-0.6b")
    mesh = MeshShape((16, 16))
    specs = SH.param_specs(cfg, MD.param_shapes(cfg), mesh)
    shp = MD.param_shapes(cfg)
    assert SH.local_shape(shp["embed"], specs["embed"], mesh) == (1, 151936 // 16, 1024)
    lay = shp["layers"]["attn"]
    assert SH.local_shape(lay["wq"], specs["layers"]["attn"]["wq"], mesh) == (28, 1024, 128)
    assert SH.local_shape(lay["wk"], specs["layers"]["attn"]["wk"], mesh) == (28, 1024, 1024)


def world_layouts(rank, world, shape, cases, fsdp):
    """shard_params then gather_params of each case's full tree; the rank's
    in_proj of a Mamba config."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(shape)
    out = {}
    for name, (arch, change) in cases.items():
        cfg = W.tp_cfg(arch, **change)
        full = MD.init_params(cfg, torch.Generator().manual_seed(0))
        shards = SH.shard_params(cfg, full, mesh, fsdp)
        back = SH.gather_params(cfg, shards, mesh, fsdp)
        out[name] = {
            "equal": all(torch.equal(a, b) for a, b in zip(
                MD.flatten(full).values(), MD.flatten(back).values())),
            "local": {k: tuple(v.shape) for k, v in MD.flatten(shards).items()}}
        if cfg.uses_ssm:
            out[name]["in_proj"] = (W._np(shards["layers"]["ssm"]["in_proj"]),
                                    W._np(full["layers"]["ssm"]["in_proj"]))
    return out


LAYOUT_CASES = {"falcon_mamba_7b": ("falcon_mamba_7b", {}),
                "hymba_1_5b": ("hymba_1_5b", {}),
                "musicgen_large": ("musicgen_large", {}),
                "olmoe_1b_7b": ("olmoe_1b_7b", {}),
                "hymba_degrade": ("hymba_1_5b", dict(n_heads=3, n_kv_heads=1,
                                                     vocab_size=513))}


@pytest.mark.parametrize("shape,fsdp", [((2, 2), False), ((2, 2), True),
                                        ((1, 4), None)])
def test_gather_inverts_shard(shape, fsdp):
    ranks = run_world(world_layouts, int(np.prod(shape)), backend="gloo",
                      timeout=300, args=(shape, LAYOUT_CASES, fsdp))
    for r, rr in enumerate(ranks):
        for name, res in rr.items():
            assert res["equal"], (r, name)
            cfg = W.tp_cfg(*LAYOUT_CASES[name][:1], **LAYOUT_CASES[name][1])
            mesh = MeshShape(shape, r)
            specs = SH.param_specs(cfg, MD.param_shapes(cfg), mesh, fsdp)
            for k, shp in MD.flatten(MD.param_shapes(cfg)).items():
                assert res["local"][k] == SH.local_shape(
                    shp, MD.flatten(specs)[k], mesh), (name, k)
            if "in_proj" in res:
                got, full = res["in_proj"]
                di = full.shape[-1] // 2
                tp, m = shape[-1], r % shape[-1]
                if "model" in MD.flatten(specs)["layers/ssm/in_proj"]:
                    per = di // tp
                    want = np.concatenate([full[..., m * per:(m + 1) * per],
                                           full[..., di + m * per:di + (m + 1) * per]], -1)
                    if fsdp:
                        want = np.split(want, shape[0], axis=-2)[r // shape[-1]]
                    np.testing.assert_array_equal(got, want)

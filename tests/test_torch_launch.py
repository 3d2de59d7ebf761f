"""The port's launch tooling against the JAX package: shapes and parameter
counts (``configs/base.py``), the ``meta`` stand-ins of ``launch/specs.py``
against JAX's ``eval_shape`` specs, and the sharding rules of
``parallel/sharding.py`` against JAX's ``param_pspec``, ``batch_pspecs``,
``prune_pspec`` and ``cache_pspecs``, on the production mesh shapes.

Every comparison is exact: shapes, dtypes, counts and specs.  The one
stated difference: the port's slot cache has one trash position per row
(``max_len + 1``), where JAX's has ``max_len``.
"""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import reduced_config as jreduced
from repro.launch import specs as JS
from repro.models.transformer import init_paged_cache as j_init_paged_cache
from repro.parallel import sharding as JSH
from repro.train import optim as JO
from repro_torch.configs import SHAPES, get_config, list_archs, reduced_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import MeshShape, batch_axes, mesh_tag, production_mesh_shape
from repro_torch.models.transformer import init_paged_cache, init_params
from repro_torch.parallel import sharding as SH
from repro_torch.train import optim as O
from repro_torch.train.tree import leaves

ARCHS = list_archs()
MESHES = [production_mesh_shape(), production_mesh_shape(multi_pod=True)]


class _FakeMesh:
    """The JAX test's stand-in: rule logic without devices."""

    def __init__(self, shape):
        self.shape = shape

    @property
    def axis_names(self):
        return tuple(self.shape)


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype)) for k, v in flat]


def _port_leaves(tree):
    out = []
    for path, t in SH.named_leaves(tree):
        assert t.device.type == "meta", path
        out.append((path, tuple(t.shape), str(t.dtype).replace("torch.", "")))
    return out


def _jax_cfg(arch):
    return jget(arch)


def test_archs_are_jax_archs():
    from repro.configs import list_archs as jlist
    assert ARCHS == jlist()
    assert len(ARCHS) == 10


def test_shapes_equal_jax():
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        j = JSHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_jax(arch, reduced):
    cfg, jcfg = get_config(arch), jget(arch)
    if reduced:
        cfg, jcfg = reduced_config(cfg), jreduced(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.supports_long_context == jcfg.supports_long_context


def test_granite_parameters():
    cfg = get_config("granite-3-2b")
    assert cfg.param_count() == 2_634_035_200
    assert cfg.active_param_count() == cfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch):
    """Every leaf of input_specs (4 shapes), params_specs (float and
    frozen), cache_specs (the slot cache, + 1 position) and state_specs at
    full width, in JAX's flatten order and key strings."""
    cfg, jcfg = get_config(arch), _jax_cfg(arch)
    for name in SHAPES:
        got = _port_leaves(S.input_specs(cfg, SHAPES[name]))
        assert got == _jax_leaves(JS.input_specs(jcfg, JSHAPES[name])), name
    assert _port_leaves(S.params_specs(cfg)) == _jax_leaves(JS.params_specs(jcfg))
    # a quantized config: the frozen tree holds QWeights (float keeps floats)
    q = dataclasses.replace(cfg, approx=dataclasses.replace(cfg.approx, mode="kernel"))
    from repro.core.approx import ApproxConfig as JApprox
    jq = dataclasses.replace(jcfg, approx=JApprox(mode="pallas"))
    assert _port_leaves(S.params_specs(q, frozen=True)) == _jax_leaves(
        JS.params_specs(jq, frozen=True))
    assert _port_leaves(S.state_specs(cfg, O.OptConfig())) == _jax_leaves(
        JS.state_specs(jcfg, JO.OptConfig()))
    shape = SHAPES["long_500k" if cfg.supports_long_context else "decode_32k"]
    got = _port_leaves(S.cache_specs(cfg, shape))
    want = _jax_leaves(JS.cache_specs(jcfg, JSHAPES[shape.name]))
    plus_one = [(p, s[:2] + (s[2] + 1,) + s[3:] if p in ("['k']", "['v']") else s, d)
                for p, s, d in want]
    assert got == plus_one


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_matches_cpu_init(arch):
    cfg = reduced_config(get_config(arch))
    meta, cpu = init_params(cfg, device="meta"), init_params(cfg, device="cpu")
    assert [(p, t.shape, t.dtype) for p, t in SH.named_leaves(meta)] == [
        (p, t.shape, t.dtype) for p, t in SH.named_leaves(cpu)]
    assert all(t.device.type == "meta" for t in leaves(meta))


def test_mesh_shapes():
    single, multi = MESHES
    assert (single.axis_names, single.shape, mesh_tag(single)) == (
        ("data", "model"), {"data": 16, "model": 16}, "16x16")
    assert (multi.axis_names, mesh_tag(multi)) == (("pod", "data", "model"), "2x16x16")
    assert batch_axes(single) == ("data",) and batch_axes(multi) == ("pod", "data")
    assert batch_axes(MeshShape((("model", 4),))) == ()


def _mesh_pair(mesh):
    return _FakeMesh(mesh.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch):
    """param_pspec of every float and frozen parameter leaf on both mesh
    shapes, and the MoE's expert-parallel variant (64 experts)."""
    cfg, jcfg = get_config(arch), _jax_cfg(arch)
    cases = [(cfg, jcfg)]
    if cfg.family == "moe":
        cases.append((dataclasses.replace(cfg, moe_experts=64),
                      dataclasses.replace(jcfg, moe_experts=64)))
    n = 0
    for c, jc in cases:
        q = dataclasses.replace(c, approx=dataclasses.replace(c.approx, mode="kernel"))
        for tree in (S.params_specs(c), S.params_specs(q, frozen=True)):
            for mesh in MESHES:
                fake = _mesh_pair(mesh)
                for path, t in SH.named_leaves(tree):
                    shape = tuple(t.shape)
                    want = tuple(JSH.param_pspec(path, shape, jc, fake))
                    assert SH.param_pspec(path, shape, c, mesh) == want, (path, mesh_tag(mesh))
                    n += 1
    assert n > 0


def test_param_rules_dense_and_moe():
    """The JAX test's own cases, through the port."""
    mesh = MESHES[0]
    cfg = get_config("granite-3-2b")
    assert SH.param_pspec("['layers']['attn'].wq", (40, 2048, 2048), cfg, mesh) == (
        None, "data", "model")
    assert SH.param_pspec("['layers']['ffn'].w_down", (40, 8192, 2048), cfg, mesh) == (
        None, "model", "data")
    assert SH.param_pspec("['embed']", (49155, 2048), cfg, mesh) == (None, "data")
    assert SH.param_pspec("['layers']['ln1']", (40, 2048), cfg, mesh) == ()
    moe = get_config("qwen2-moe-a2.7b")
    assert SH.param_pspec("['layers']['moe'].w_gate", (24, 60, 2048, 1408), moe, mesh) == (
        None, None, "data", "model")
    moe64 = dataclasses.replace(moe, moe_experts=64)
    assert SH.param_pspec("['layers']['moe'].w_gate", (24, 64, 2048, 1408), moe64, mesh) == (
        None, "model", "data", None)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspecs_match_jax(arch):
    cfg, jcfg = get_config(arch), _jax_cfg(arch)
    for mesh in MESHES + [MeshShape((("model", 4),))]:
        for kind in ("train", "prefill", "decode"):
            want = {k: tuple(v) for k, v in JSH.batch_pspecs(jcfg, _mesh_pair(mesh),
                                                             kind).items()}
            assert SH.batch_pspecs(cfg, mesh, kind) == want


def test_prune_pspec_matches_jax():
    specs = [("data",), (("pod", "data"),), ("data", "model"), (None, "model"),
             (("pod", "data"), None, "model"), ("model",), ()]
    shapes = [(7,), (32,), (1, 16), (256, 48), (2, 3, 16), (16, 15, 4)]
    for mesh in MESHES + [MeshShape((("data", 1),)), MeshShape((("model", 4),))]:
        fake = _mesh_pair(mesh)
        for spec in specs:
            for shape in shapes:
                from jax.sharding import PartitionSpec as P
                want = tuple(JSH.prune_pspec(fake, P(*spec), shape))
                assert SH.prune_pspec(mesh, spec, shape) == want, (spec, shape, mesh_tag(mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_jax(arch):
    """Both layouts, every leaf, on both mesh shapes (JAX through an
    ``AbstractMesh``).  The rules are functions of the leaves' shapes, so
    the slot layout is held on JAX's own shapes: on the port's (+ 1
    position) the sequence-parallel fallback cannot split the length."""
    cfg, jcfg = get_config(arch), _jax_cfg(arch)
    shape = JSHAPES["long_500k" if cfg.supports_long_context else "decode_32k"]
    jcache = JS.cache_specs(jcfg, shape)
    meta = {k: torch.empty(v.shape, device="meta") for k, v in jcache.items()}
    layouts = [("slots", jcache, meta)]
    if cfg.family not in ("ssm", "hybrid"):
        jpaged = jax.eval_shape(lambda: j_init_paged_cache(jcfg, 64, 16))
        layouts.append(("paged", jpaged, init_paged_cache(cfg, 64, 16, device="meta")))
    for mesh in MESHES:
        amesh = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
        for layout, jc, pc in layouts:
            want = {k: tuple(v.spec) for k, v in JSH.cache_pspecs(jcfg, amesh, jc,
                                                                 layout=layout).items()}
            got = SH.cache_pspecs(cfg, mesh, pc, layout=layout)
            # JAX's NamedSharding trims trailing Nones; compare padded
            pad = lambda s, n: tuple(s) + (None,) * (n - len(s))
            assert {k: pad(v, len(pc[k].shape)) for k, v in got.items()} == {
                k: pad(v, len(pc[k].shape)) for k, v in want.items()}, (layout, mesh_tag(mesh))
    with pytest.raises(ValueError, match="unknown layout"):
        SH.cache_pspecs(cfg, MESHES[0], meta, layout="ring")

"""The port's sharding layer against the JAX package's, as pure logic.

``rules_for_cell``, the batch / decode / parameter / optimizer-state axes
and the elastic mesh arithmetic are compared key for key with the
reference for every config, every shape cell and the meshes (1, 1),
(16, 16) and (2, 16, 16). The reference reads only a mesh's ``shape`` and
``axis_names``, so both packages get a duck-typed mesh. The reference stacks
each superblock position's parameters (a leading None axis); the port keeps
one leaf per layer, mapped to its stack by ``lm.stack_groups``.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_config as ref_get_config, shape_cells as ref_cells
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro.models import lm as ref_lm
from repro.sharding import partition as ref_part
from repro.training import optimizer as ref_opt
from repro_torch.configs.base import get_config, shape_cells
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.sharding import partition as part
from repro_torch.training import optimizer as opt

ROOT = Path(__file__).resolve().parent.parent

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
# the only leaves where the reference's ZeRO axis lands on its stacked-layer
# dim (ROADMAP C16): jamba's mamba vectors and conv weight on a data axis of
# one rank (every dim divides 1; the stack of 4 is the largest or first
# eligible dim), so no byte moves
STACK_DIM_ZERO = {("1x1", "jamba_v0_1_52b"): {
    f"blocks.{i}.mamba.{leaf}" for i in (0, 1, 2, 3, 5, 6, 7)
    for leaf in ("D", "conv_b", "conv_w", "dt_bias")}}


def _mesh(name):
    shape, names = MESHES[name]
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


def _leaf(tree, path):
    for k in path.split("."):
        tree = tree[int(k)] if isinstance(tree, tuple) else tree[k]
    return tree


def _norm(spec) -> tuple:
    """A spec with one-axis tuples written as the axis (``PartitionSpec``'s form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _ref_param_axis(name, ref_tree, groups):
    """The reference's axes for the port's leaf ``name``, the stacked dim dropped."""
    g = groups[name]
    ax = tuple(_leaf(ref_tree, g))
    return ax[1:] if g != name else ax


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_for_cell_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert [s.name for s in shape_cells(cfg)] == [s.name for s in ref_cells(rcfg)]
    for mname in MESHES:
        mesh = _mesh(mname)
        for shape in shape_cells(cfg):
            ours = part.rules_for_cell(cfg, shape, mesh)
            ref = ref_part.rules_for_cell(rcfg, shape, mesh)
            assert ours.rules == ref.rules, (mname, shape.name)
            for axes in (("batch", "seq", None), ("cache_batch", "cache_seq", None, None),
                         ("expert", "embed", "expert_ff"), ("embed", "vocab")):
                assert _norm(ours.spec(axes)) == _norm(ref.spec(axes)), (mname, shape.name, axes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_decode_and_param_axes_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape in shape_cells(cfg):
        if shape.kind == "decode":
            assert steps.decode_axes(cfg, shape) == ref_steps.decode_axes(rcfg, shape), shape.name
        else:
            assert steps.batch_axes(cfg, shape) == ref_steps.batch_axes(rcfg, shape), shape.name
    p_axes = steps.param_axes(cfg)
    ref_tree = ref_lm.model_param_axes(rcfg)
    groups = lm.stack_groups(cfg, list(p_axes))
    for name, axes in p_axes.items():
        assert axes == _ref_param_axis(name, ref_tree, groups), name
    shapes = steps.param_specs(cfg)
    ref_abs = ref_lm.abstract_model(rcfg)
    for name, (shp, _) in shapes.items():
        ref_shape = tuple(_leaf(ref_abs, groups[name]).shape)
        assert tuple(shp) == (ref_shape[1:] if groups[name] != name else ref_shape), name


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_axes_equal_reference(arch, mname):
    """ZeRO-1 axes at the mesh's data size with the rules' replicated and
    data-resident sets; where the reference picks its stacked dim the port
    applies the same rule to the layer's own dims (C16)."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    mesh = _mesh(mname)
    shape = next(s for s in shape_cells(cfg) if s.kind == "train")
    rules = ref_part.rules_for_cell(rcfg, shape, mesh)
    zs = mesh.shape["data"]
    repl = frozenset(k for k, v in rules.rules.items() if v is None)
    dres = frozenset(k for k, v in rules.rules.items()
                     if v == "data" or (isinstance(v, tuple) and "data" in v))
    ref = ref_opt.opt_axes(ref_lm.model_param_axes(rcfg), ref_lm.abstract_model(rcfg),
                           zero_size=zs, replicated_names=repl, data_resident_names=dres)
    p_axes, p_specs = steps.param_axes(cfg), steps.param_specs(cfg)
    ours = opt.opt_axes(p_axes, p_specs, zero_size=zs, replicated_names=repl,
                        data_resident_names=dres)
    assert set(ours) == {"master", "m", "v", "count"} and ours["count"] == ref["count"] == ()
    groups = lm.stack_groups(cfg, list(p_axes))
    stack_dim = set()
    for name, axes in ours["master"].items():
        assert ours["m"][name] == ours["v"][name] == axes
        g = groups[name]
        ref_axes = tuple(_leaf(ref["master"], g))
        if g != name and ref_axes[0] == "zero":
            stack_dim.add(g)
            single = ref_opt.opt_axes(
                {"x": p_axes[name]},
                {"x": jax.ShapeDtypeStruct(p_specs[name][0], jax.numpy.float32)},
                zero_size=zs, replicated_names=repl, data_resident_names=dres)["master"]["x"]
            assert axes == tuple(single), name
            assert zs == 1  # no byte of difference: the zero axis has one rank
        else:
            assert axes == (ref_axes[1:] if g != name else ref_axes), name
    assert stack_dim == STACK_DIM_ZERO.get((mname, arch), set())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adafactor_axes_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    p_axes, p_specs = steps.param_axes(cfg), steps.param_specs(cfg)
    ours = opt.adafactor_axes(p_axes, p_specs)
    ref = ref_opt.adafactor_axes(ref_lm.model_param_axes(rcfg), ref_lm.abstract_model(rcfg))
    groups = lm.stack_groups(cfg, list(p_axes))
    for name, fac in ours["factors"].items():
        g = groups[name]
        rfac = _leaf(ref["factors"], g)
        assert set(fac) == set(rfac), name
        for k, axes in fac.items():
            assert axes == (tuple(rfac[k])[1:] if g != name else tuple(rfac[k])), (name, k)
    assert ours["count"] == ref["count"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cell_axes_match_specs(kind):
    """Every cell's axes tree has one axes tuple per spec leaf, of its rank."""
    cfg = get_config("jamba_v0_1_52b")
    shape = next(s for s in shape_cells(cfg) if s.kind == kind)
    cell = steps.cell_step_and_specs(cfg, shape, zero_size=16)
    assert cell.kind == kind and set(cell.specs) == set(cell.axes)
    n = 0

    def check(axes, spec):
        nonlocal n
        n += 1
        assert len(axes) == len(spec[0])

    from repro_torch.models.params import map_axes
    for k in cell.specs:
        map_axes(check, cell.axes[k], cell.specs[k])
    assert n > 10


@pytest.mark.parametrize("n,mp", [(7, 16), (16, 16), (40, 16), (512, 16), (256, 8), (1, 1)])
def test_elastic_mesh_arithmetic(n, mp):
    if n < mp:
        with pytest.raises(ValueError) as ours:
            port_mesh.elastic_shape(n, model_parallel=mp)
        with pytest.raises(ValueError) as ref:
            ref_mesh.elastic_mesh(n, model_parallel=mp)
        assert str(ours.value) == str(ref.value)
        return
    data, model = port_mesh.elastic_shape(n, model_parallel=mp)
    assert model == mp and data * mp <= n < 2 * data * mp and data & (data - 1) == 0
    if n == mp == 1:  # the only mesh the reference can build on one host device
        ref = ref_mesh.elastic_mesh(n, model_parallel=mp)
        assert dict(ref.shape) == {"data": data, "model": model}


def test_placements_and_specs():
    mesh = SimpleNamespace(axis_names=("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard
    assert part.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert part.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        part.placements(("model", "model"), mesh)
    rules = part.ShardingRules.default(mesh)
    assert rules.spec(("batch", "seq", "ff")) == (("pod", "data"), None, "model")
    assert rules.with_overrides(seq="model").spec(("seq",)) == ("model",)


def test_hint_is_identity_without_rules():
    assert part.current_rules() is None
    x = torch.zeros(2, 3, 4)
    assert part.hint(x, "batch", "seq", None) is x
    assert part.hint(x, "a") is x  # no rules: not even the rank is read
    assert part.logical_to_spec(("batch",)) is None and part.named_sharding(("batch",)) is None
    cache = torch.zeros(2, 5, 3)
    part.write_slot(cache, 3, torch.ones(2, 3))
    assert cache[:, 3].eq(1).all() and cache.sum() == 6
    with part.use_rules(part.ShardingRules.default(_mesh("16x16"))) as r:
        assert part.current_rules() is r
        assert part.hint(x, "batch", "seq", None) is x  # a plain tensor passes through
        with pytest.raises(ValueError):
            part.hint(x, "batch")
    assert part.current_rules() is None


def test_production_meshes_on_the_fake_world():
    """The meshes the launchers build: shapes, axis names, the fake world's
    size (in a child process: the fake world stays out of this one)."""
    code = """
from repro_torch.launch import mesh as M
import torch.distributed as dist
single, multi = M.make_production_mesh(), M.make_production_mesh(multi_pod=True)
el = M.elastic_mesh(40, model_parallel=8)
print(tuple(single.shape), single.mesh_dim_names, tuple(multi.shape), multi.mesh_dim_names,
      tuple(el.shape), M.data_axis_size(el), M.mesh_axis(multi, "pod"), dist.get_world_size())
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == (
        "(16, 16) ('data', 'model') (2, 16, 16) ('pod', 'data', 'model') (4, 8) 4 2 512")

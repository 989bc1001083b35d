"""The port's logical-axis sharding (``repro_torch.distributed.sharding``)
against the reference's: the tier-1 cases of ``tests/test_distributed.py``
run in both packages on the same meshes, plus ZeRO-1's spec and the elastic
mesh shape. Specs compare as tuples (the port's ``P`` and JAX's
``PartitionSpec`` are both tuples of mesh-axis names)."""
import types

import pytest
import torch
import torch.distributed as dist

from jax.sharding import PartitionSpec as JP

from repro.distributed import fault_tolerance as jft
from repro.distributed import sharding as jshd

from repro_torch.distributed import best_mesh_shape
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as tsp
from repro_torch.launch.mesh import make_profile_mesh
from repro_torch.models.common import ParamDef


def jmesh(shape, names):
    from repro.compat import make_mesh
    return make_mesh(shape, names)


@pytest.fixture
def one_rank():
    """A gloo process group of one rank for the meshes with devices."""
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield
    if made:
        dist.destroy_process_group()


def test_resolve_basic():
    want = jshd._resolve(jmesh((1, 1), ("data", "model")),
                         jshd.DEFAULT_PARAM_RULES, ("embed", "heads"),
                         (64, 64))
    got = shd._resolve(shd.AbstractMesh({"data": 1, "model": 1}),
                       shd.DEFAULT_PARAM_RULES, ("embed", "heads"), (64, 64))
    # axes of size 1 are dropped by the divisibility guard
    assert tuple(got) == tuple(want) == ()


@pytest.mark.parametrize("shape", [(8, 2, 64, 4), (8, 8, 64, 4),
                                   (1, 2, 64, 4)])
def test_resolve_divisibility_guard(shape):
    """kv_heads=2 on a 4-way model axis falls back to cache_seq sharding;
    divisible kv_heads win the model axis (cache_seq then drops: the axis
    is used); batch=1 drops the batch sharding. The reference's
    ``_resolve`` reads only ``mesh.shape``, as the port's does."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    logical = ("batch", "kv_heads", "cache_seq", None)
    want = jshd._resolve(mesh, jshd.DEFAULT_ACT_RULES, logical, shape)
    got = shd._resolve(mesh, shd.DEFAULT_ACT_RULES, logical, shape)
    assert tuple(got) == tuple(want)
    assert tuple(shd._resolve(shd.AbstractMesh(mesh.shape),
                              shd.DEFAULT_ACT_RULES, logical, shape)) \
        == tuple(want)


def test_rules_are_the_references():
    assert shd.DEFAULT_ACT_RULES == jshd.DEFAULT_ACT_RULES
    assert shd.DEFAULT_PARAM_RULES == jshd.DEFAULT_PARAM_RULES
    assert shd.SERVE_PARAM_RULES == jshd.SERVE_PARAM_RULES


def test_constrain_noop_without_mesh():
    x = torch.ones(4, 4)
    assert shd.constrain(x, "batch", "embed") is x
    with shd.use_mesh(shd.AbstractMesh({"data": 1, "model": 1})):
        assert shd.constrain(x, "batch", "embed") is x


def test_probe_sharding_helpers(one_rank):
    """Axis sizing, pad-to-shard-multiple arithmetic and the replication
    fallback when a mesh lacks the requested axis, in both packages."""
    mesh = types.SimpleNamespace(shape={"probe": 4, "data": 2})
    for m in (shd, jshd):
        assert m.probe_axis_size(None) == 1
        assert m.probe_axis_size(mesh, "probe") == 4
        assert m.probe_axis_size(mesh, "nope") == 1
        assert m.pad_to_shards(7, None) == 7
        assert m.pad_to_shards(0, mesh, "probe") == 0
        assert m.pad_to_shards(1, mesh, "probe") == 4
        assert m.pad_to_shards(7, mesh, "probe") == 8
        assert m.pad_to_shards(8, mesh, "probe") == 8

    real = make_profile_mesh(1, 1, device="cpu")
    jreal = jmesh((1, 1), ("probe", "data"))
    pairs = [(shd.probe_sharding(real, "probe"),
              jshd.probe_sharding(jreal, "probe")),
             (shd.probe_sharding(real, "absent"),
              jshd.probe_sharding(jreal, "absent")),
             (shd.batch_sharding(real, "data"),
              jshd.batch_sharding(jreal, "data")),
             (shd.replicated(real), jshd.replicated(jreal))]
    for got, want in pairs:
        assert tuple(got.spec) == tuple(want.spec)
    assert tuple(shd.probe_sharding(real, "probe").spec) == ("probe",)
    rows = {"x": torch.arange(12).reshape(6, 2)}
    assert torch.equal(shd.drop_padded_rows(rows, 4)["x"],
                       torch.arange(8).reshape(4, 2))


def test_flatten_arg_shardings(one_rank):
    """Per-argument prefix broadcasting onto the flat (args, kwargs) leaf
    list, in both packages: one prefix entry covers its whole argument
    subtree, a single sharding broadcasts to positional leaves only, and
    kwargs leaves always replicate."""
    tmesh = make_profile_mesh(1, 1, device="cpu")
    jm = jmesh((1, 1), ("probe", "data"))
    params = {"w1": 1, "w2": 2}
    batch = {"x": 3, "y": 4}

    def both(t_sh, j_sh, args, kwargs):
        got = shd.flatten_arg_shardings(tmesh, t_sh, args, kwargs)
        want = jshd.flatten_arg_shardings(jm, j_sh, args, kwargs)
        assert [tuple(s.spec) for s in got] == [tuple(s.spec) for s in want]
        return [tuple(s.spec) for s in got]

    assert both(None, None, (params, batch), {}) == [()] * 4
    assert both([None, shd.batch_sharding(tmesh, "data")],
                [None, jshd.batch_sharding(jm, "data")],
                (params, batch), {}) == [(), (), ("data",), ("data",)]
    assert both(shd.P("data"), JP("data"), (params,), {"scale": 5}) == \
        [("data",), ("data",), ()]
    assert both((shd.P("data"), None), (JP("data"), None), (params, batch),
                {"k": 0}) == [("data",), ("data",), (), (), ()]
    assert shd.flatten_arg_shardings(None, None, (params,), {}) is None
    with pytest.raises(ValueError):
        shd.flatten_arg_shardings(tmesh, [None, None, None],
                                  (params, batch), {})
    with pytest.raises(ValueError):
        jshd.flatten_arg_shardings(jm, [None, None, None], (params, batch),
                                   {})


@pytest.mark.parametrize("shape,axes", [
    ((8, 64, 32), ("layers", "embed", "mlp")),
    ((64, 48), ("embed", "heads")),
    ((6, 64), (None, "embed")),
    ((64,), ("embed",)),
])
def test_zero1_spec(shape, axes):
    """TP over the model axis, then 'data' on the first free divisible dim.
    The reference's ``_zero1_spec`` builds a ``NamedSharding``, which needs
    a mesh of eight devices; its spec is computed here from the
    reference's ``_resolve`` by its own steps."""
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
    got = tsp._zero1_spec(ParamDef(shape, axes), mesh)
    base = jshd._resolve(mesh, jshd.SERVE_PARAM_RULES, axes, shape)
    spec = list(base) + [None] * (len(shape) - len(base))
    for i, (dim, cur) in enumerate(zip(shape, spec)):
        if cur is None and dim % 4 == 0:
            spec[i] = "data"
            break
    assert tuple(got.spec) == tuple(spec)
    # TP-only base: embed not sharded, mlp on model (the reference's case)
    if axes == ("layers", "embed", "mlp"):
        assert tuple(base) == (None, None, "model")


@pytest.mark.parametrize("n,mp", [(512, 16), (256, 16), (24, 16), (7, 16),
                                  (8, 2), (1, 16)])
def test_best_mesh_shape(n, mp):
    assert best_mesh_shape(n, mp) == jft.best_mesh_shape(n, mp)

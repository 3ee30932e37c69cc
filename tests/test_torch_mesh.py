"""The port's logical-axis sharding substrate and local mesh
(``repro_torch.dist.sharding``, ``repro_torch.launch.mesh``) against the
JAX package's (``repro.dist.sharding``) on the CPU, on the suite's 8
fake devices (``tests/conftest.py``) with ``Auto`` mesh axes:

* the rules table, the lookups in and out of a ``sharding_ctx``,
  ``_sanitize_spec``, ``named_shardings`` and ``param_partition_specs``
  of LM and GNN trees: equal;
* the local ``shard_map``'s split of its inputs and assembly of its
  outputs, against ``jax.shard_map`` on the same arrays: equal;
* ``all_gather``, ``all_to_all``, ``pmean`` and ``axis_index`` against
  ``lax``'s under ``jax.shard_map``: equal (the values are small
  integers, so every sum is exact), and autograd through them;
* what the executor refuses: shards that ask for different collectives,
  a shard that raises (the others are closed), a tensor off the mesh's
  device, a dim the mesh does not divide.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as j_get_arch
from repro.configs import tgn_gdelt as j_gnn_cfgs
from repro.dist import sharding as JS
from repro.models import gnn as JG
from repro.models import lm_zoo as JZ
from repro_torch.dist import sharding as TS
from repro_torch.launch import mesh as TMesh

P = TS.P


def _jmesh(data, model):
    return jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _tmesh(data, model):
    return TMesh.make_local_mesh(data, model, device="cpu")


def _spec_tree(tree):
    """A spec tree (JAX's or the port's) as nested dicts/lists of
    tuples."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v) for v in tree]
    return tuple(tree)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def test_local_mesh_is_logical_and_production_mesh_is_shape_only():
    m = _tmesh(2, 4)
    assert m.axis_names == ("data", "model") and m.shape == {
        "data": 2, "model": 4}
    assert m.device == torch.device("cpu")
    assert _tmesh(1, 16).shape["model"] == 16   # no clamp to a device count
    for multi in (False, True):
        j = TMesh.make_production_mesh(multi_pod=multi)
        assert j.device is None
        assert j.shape == ({"pod": 2, "data": 16, "model": 16} if multi
                           else {"data": 16, "model": 16})
        with pytest.raises(ValueError, match="no device"):
            TS.shard_map(lambda x: x, mesh=j, in_specs=(P(),),
                         out_specs=P())
    with pytest.raises(ValueError):
        TMesh.Mesh(("data", "data"), (1, 2))
    assert TMesh.HW["peak_flops_bf16"] == 989e12
    assert TMesh.HW["hbm_bw"] == 3.35e12


# ---------------------------------------------------------------------------
# rules and lookups
# ---------------------------------------------------------------------------


def test_rules_table_matches_jax():
    for multi in (False, True):
        assert (TS.default_rules(multi_pod=multi).table
                == JS.default_rules(multi_pod=multi).table)
    assert TS.LOGICAL_AXES == JS.LOGICAL_AXES
    t = TS.ShardingRules({"batch": ("data",), "tp": "model"})
    j = JS.ShardingRules({"batch": ("data",), "tp": "model"})
    assert t.get("batch") == j.get("batch") and t.get("x") is None
    assert t.override(tp=None, vocab="model").table == j.override(
        tp=None, vocab="model").table
    assert t == TS.ShardingRules(dict(t.table)) and t != t.override(tp=None)
    assert t.table == {"batch": ("data",), "tp": "model"}  # untouched


def test_lookups_outside_a_context():
    assert TS.active_mesh() is None and TS.active_rules() is None
    assert TS.axis_for("batch") is None and TS.axis_size_of("tp") == 1
    x = torch.ones(4, 4)
    assert TS.constrain(x, "batch", "tp") is x
    tree = {"wq": x}
    assert TS.gather_fsdp(tree) is tree
    with pytest.raises(ValueError, match="explicit rules"):
        TS.param_partition_specs(tree)


_RULES = {
    "default": lambda m: m.default_rules(),
    "multi_pod": lambda m: m.default_rules(multi_pod=True),
    "partial": lambda m: m.ShardingRules(
        {"batch": ("data", "model"), "tp": ("model", "pod"),
         "seq_act": "absent"}),
}


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (8, 1)])
@pytest.mark.parametrize("rules", sorted(_RULES))
def test_lookups_in_a_context_match_jax(shape, rules):
    jm, tm = _jmesh(*shape), _tmesh(*shape)
    jr, tr = _RULES[rules](JS), _RULES[rules](TS)
    names = TS.LOGICAL_AXES + ("unknown",)
    with JS.sharding_ctx(jm, jr):
        want = [(JS.axis_for(n), JS.axis_size_of(n)) for n in names]
    with TS.sharding_ctx(tm, tr):
        assert TS.active_mesh() is tm and TS.active_rules() == tr
        got = [(TS.axis_for(n), TS.axis_size_of(n)) for n in names]
        with TS.sharding_ctx(_tmesh(1, 1), TS.default_rules()):
            assert TS.axis_size_of("tp") == 1
        assert TS.active_mesh() is tm
    assert got == want
    assert TS.active_mesh() is None


@pytest.mark.parametrize("entries,shape", [
    (("data", "model"), (4, 8)),
    (("model", "model"), (8, 8)),              # an axis used twice
    (("pod", "data"), (4, 4)),                 # an axis not in the mesh
    ((("pod", "data"), "model"), (4, 4)),
    ((("data", "model"), None), (8, 3)),       # one dim over two axes
    ((("data", "model"), None), (4, 3)),       # 4 % 8: replicated
    (("data", "model"), (3, 6)),               # 3 % 2, 6 % 4
    (("data", "model", None), None),           # no shape
    ((None, ("model", "data")), (2, 16)),
])
def test_sanitize_spec_matches_jax(entries, shape):
    assert (TS._sanitize_spec(_tmesh(2, 4), entries, shape)
            == JS._sanitize_spec(_jmesh(2, 4), entries, shape))


def test_named_shardings_matches_jax():
    tree = {"a": [("pod", "data"), ("model",)],
            "b": {"c": [None, "model", ("data", "model")]}}
    jt = {"a": JP(*tree["a"]), "b": {"c": JP(*tree["b"]["c"])}}
    tt = {"a": P(*tree["a"]), "b": {"c": P(*tree["b"]["c"])}}
    want = jax.tree.map(lambda s: tuple(s.spec),
                        JS.named_shardings(_jmesh(2, 4), jt),
                        is_leaf=lambda s: isinstance(s, NamedSharding))
    assert _spec_tree(TS.named_shardings(_tmesh(2, 4), tt)) == want
    assert repr(P(("data",), None)) == "P('data', None)"


def _meta(tree):
    """A JAX tree of arrays or shape structs -> meta tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    return torch.empty(tuple(tree.shape), device="meta")


def _lm_tree(arch):
    return JZ.param_specs(j_get_arch(arch).reduced())


def _gnn_tree(name):
    cfg = j_gnn_cfgs.GNN_MODELS[name]()
    return jax.eval_shape(lambda: JG.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("tree", [
    "lm:qwen3-moe-235b-a22b", "lm:llama4-scout-17b-a16e", "lm:zamba2-2.7b",
    "lm:falcon-mamba-7b", "gnn:tgn", "gnn:tgat", "gnn:gat"])
@pytest.mark.parametrize("where", ["rules", "ctx"])
def test_param_partition_specs_match_jax(tree, where):
    kind, name = tree.split(":")
    jtree = _lm_tree(name) if kind == "lm" else _gnn_tree(name)
    ttree = _meta(jtree)
    rules = TS.default_rules().override(vocab="model")
    jrules = JS.default_rules().override(vocab="model")
    if where == "rules":
        want = JS.param_partition_specs(jtree, jrules)
        got = TS.param_partition_specs(ttree, rules)
    else:
        with JS.sharding_ctx(_jmesh(2, 4), jrules):
            want = JS.param_partition_specs(jtree)
        with TS.sharding_ctx(_tmesh(2, 4), rules):
            got = TS.param_partition_specs(ttree)
    want = jax.tree.map(tuple, want, is_leaf=lambda s: isinstance(s, JP))
    assert _spec_tree(got) == want


# ---------------------------------------------------------------------------
# the local shard_map: split, assembly, collectives
# ---------------------------------------------------------------------------


def _jshard_map(body, in_specs, out_specs, *args):
    mesh = _jmesh(2, 4)
    fn = JS.shard_map(body, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def _tshard_map(body, in_specs, out_specs, *args):
    fn = TS.shard_map(body, mesh=_tmesh(2, 4), in_specs=in_specs,
                      out_specs=out_specs)
    out = fn(*(torch.from_numpy(np.asarray(a)) for a in args))
    return jax.tree.map(lambda t: t.numpy(), out,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


def _x(shape=(8, 8, 6)):
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


@pytest.mark.parametrize("specs", [
    (("data", "model", None), ("data", "model", None)),
    ((None, ("data", "model"), None), (None, ("data", "model"), None)),
    ((("model", "data"), None, None), (("model", "data"), None, None)),
    (("model", None, "data"), ("model", None, "data")),
    ((None, None, None), (None, None, None)),
    (("data", None, None), ("data", "model", None)),   # stacked over model
    (("data", "model", None), (None, None, None)),     # shard 0's block
])
def test_shard_map_split_and_assembly_match_jax(specs):
    """Each shard's view (tagged with its coordinates) put back together:
    the same array as ``jax.shard_map``'s."""
    i_spec, o_spec = specs

    def jbody(a):
        return a + 100 * lax.axis_index("data") + 1000 * lax.axis_index(
            "model")

    def tbody(a):
        return a + 100 * TS.axis_index("data") + 1000 * TS.axis_index(
            "model")
    x = _x()
    want = _jshard_map(jbody, (JP(*i_spec),), JP(*o_spec), x)
    got = _tshard_map(tbody, (P(*i_spec),), P(*o_spec), x)
    np.testing.assert_array_equal(got, want)


def test_shard_map_takes_spec_prefixes_and_trees():
    x = _x((8, 4))
    tree = {"a": torch.from_numpy(x), "b": [torch.from_numpy(x + 1)]}
    seen = []

    def body(t, y):
        seen.append((tuple(t["a"].shape), tuple(t["b"][0].shape),
                     tuple(y.shape)))
        return {"s": t["a"] * 1, "y": y, "b": t["b"]}
    fn = TS.shard_map(body, mesh=_tmesh(2, 4),
                      in_specs=(P("data", None), P(None, "model")),
                      out_specs={"s": P("data", "model"),
                                 "y": P(None, "model"),
                                 "b": [P("data", None)]})
    out = fn(tree, torch.from_numpy(x))
    assert seen == [((4, 4), (4, 4), (8, 1))] * 8
    np.testing.assert_array_equal(out["s"].numpy(), np.tile(x, (1, 4)))
    np.testing.assert_array_equal(out["y"].numpy(), x)
    np.testing.assert_array_equal(out["b"][0].numpy(), x + 1)


_COLLECTIVES = [
    ("all_gather", "model", dict(axis=1, tiled=True)),
    ("all_gather", "data", dict(axis=0, tiled=True)),
    ("all_gather", ("data", "model"), dict(axis=1, tiled=True)),
    ("all_gather", "model", dict(axis=0, tiled=False)),
    ("all_gather", ("model", "data"), dict(axis=2, tiled=False)),
    ("all_to_all", "model", dict(split_axis=0, concat_axis=1, tiled=True)),
    ("all_to_all", "model", dict(split_axis=2, concat_axis=0, tiled=True)),
    ("all_to_all", "data", dict(split_axis=1, concat_axis=2, tiled=True)),
    ("all_to_all", ("data", "model"),
     dict(split_axis=0, concat_axis=1, tiled=True)),
    ("all_to_all", "model", dict(split_axis=0, concat_axis=1, tiled=False)),
    ("all_to_all", "model", dict(split_axis=0, concat_axis=0, tiled=False)),
    ("pmean", "model", {}),
    ("pmean", ("data", "model"), {}),
    ("pmean", "data", {}),
]


@pytest.mark.parametrize("kind,names,kw", _COLLECTIVES)
def test_collectives_match_lax(kind, names, kw):
    """Per-shard (8, 4, 8) blocks of a (16, 16, 8) array of small
    integers; the result stacked on a new leading axis per shard."""
    x = _x((16, 16, 8)) % 97
    i_spec = ("data", "model", None)

    def jbody(a):
        if kind == "pmean":
            r = lax.pmean(a, names)
        elif kind == "all_gather":
            r = lax.all_gather(a, names, **kw)
        else:
            r = lax.all_to_all(a, names, kw["split_axis"], kw["concat_axis"],
                               tiled=kw["tiled"])
        return r[None, None]

    def tbody(a):
        if kind == "pmean":
            r = yield TS.pmean(a, names)
        elif kind == "all_gather":
            r = yield TS.all_gather(a, names, **kw)
        else:
            r = yield TS.all_to_all(a, names, kw["split_axis"],
                                    kw["concat_axis"], tiled=kw["tiled"])
        return r[None, None]
    if kind == "all_to_all" and not kw["tiled"]:
        x = _x((8, 16, 8)) % 97           # blocks (4, 4, 8): dim 0 is 4
    want = _jshard_map(jbody, (JP(*i_spec),), JP("data", "model"), x)
    got = _tshard_map(tbody, (P(*i_spec),), P("data", "model"), x)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("names", ["model", "data", ("data", "model"),
                                   ("model", "data")])
def test_axis_index_matches_lax(names):
    def jbody(a):
        return jnp.full((1, 1), lax.axis_index(names), jnp.int32)

    def tbody(a):
        return torch.full((1, 1), TS.axis_index(names), dtype=torch.int32)
    x = np.zeros((2, 4), np.float32)
    spec = ("data", "model")
    np.testing.assert_array_equal(
        _tshard_map(tbody, (P(*spec),), P(*spec), x),
        _jshard_map(jbody, (JP(*spec),), JP(*spec), x))
    with pytest.raises(RuntimeError, match="not inside"):
        TS.axis_index("model")


def test_autograd_through_the_collectives():
    """The all-gather's transpose sums each shard's gradient back onto
    its own rows; pmean's divides by the group: the same gradient as
    the unsharded expression."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=g, requires_grad=True)
    w = torch.randn(4, 8, generator=g)

    def body(a, wl):
        full = yield TS.all_gather(a, "model", axis=1, tiled=True)
        s = (full * full.sum(1, keepdim=True)).sum() * wl.sum()
        m = yield TS.pmean(s, ("data", "model"))
        return m
    fn = TS.shard_map(body, mesh=_tmesh(2, 4),
                      in_specs=(P("data", "model"), P("data", "model")),
                      out_specs=P())
    out = fn(x, w)
    gx, = torch.autograd.grad(out, x)
    x2 = x.detach().clone().requires_grad_(True)
    parts = [(x2[i * 2:(i + 1) * 2] * x2[i * 2:(i + 1) * 2].sum(
        1, keepdim=True)).sum() * w[i * 2:(i + 1) * 2, j * 2:(j + 1) * 2]
        .sum() for i in range(2) for j in range(4)]
    want = sum(parts) / 8
    gw, = torch.autograd.grad(want, x2)
    torch.testing.assert_close(out, want)
    torch.testing.assert_close(gx, gw)


def test_executor_refusals():
    m = _tmesh(2, 4)
    x = torch.zeros(8, 8)

    def mixed(a):
        if TS.axis_index("model") == 1:
            r = yield TS.pmean(a, "model")
        else:
            r = yield TS.all_gather(a, "model")
        return r
    with pytest.raises(RuntimeError, match="different collectives"):
        TS.shard_map(mixed, mesh=m, in_specs=(P("data", "model"),),
                     out_specs=P("data", "model"))(x)

    closed = []

    def raising(a):
        try:
            a = yield TS.pmean(a, "model")
            if TS.axis_index(("data", "model")) == 5:
                raise KeyError("shard 5")
            a = yield TS.pmean(a, "data")
            return a
        finally:
            closed.append(TS.axis_index(("data", "model")))
    with pytest.raises(KeyError, match="shard 5"):
        TS.shard_map(raising, mesh=m, in_specs=(P("data", "model"),),
                     out_specs=P("data", "model"))(x)
    assert sorted(closed) == list(range(8))

    def short(a):
        if TS.axis_index("model") == 0:
            return a
        a = yield TS.pmean(a, "model")
        return a
    with pytest.raises(RuntimeError):
        TS.shard_map(short, mesh=m, in_specs=(P("data", "model"),),
                     out_specs=P("data", "model"))(x)
    with pytest.raises(ValueError, match="does not split"):
        TS.shard_map(lambda a: a, mesh=m, in_specs=(P("model", None),),
                     out_specs=P("model", None))(torch.zeros(6, 2))
    with pytest.raises(ValueError, match="spec"):
        TS.shard_map(lambda a: a, mesh=m, in_specs=(P("pod", None),),
                     out_specs=P())(torch.zeros(6, 2))
    meta = TMesh.Mesh(("data", "model"), (2, 4), torch.device("meta"))
    with pytest.raises(ValueError, match="mesh's shards on meta"):
        TS.shard_map(lambda a: a, mesh=meta, in_specs=(P(),),
                     out_specs=P())(torch.zeros(2))

"""The port's mesh layer against the JAX package, in one process.

* ``parallel/logical.py``: the config strings (round trips, canonical
  order, and the same exception and message for every bad string), the
  rules table (``spec``, ``axis``, ``role_axis``, ``module_axis``,
  ``bind`` nesting, ``logical_partition_specs`` on a tree), each spec
  entry for entry equal to the JAX ``PartitionSpec``.
* ``parallel/mesh.py``: the rank grids of ``make_mesh``, ``hybrid_mesh``,
  ``hierarchical_mesh`` and ``LogicalMesh`` equal the JAX meshes' device
  ids, on one host (the 8 virtual CPU devices) and on fake topologies of
  2 and 4 domains (the JAX side's devices carry ``slice_index``; the
  port's ranks carry host keys), with the same error for an intra-host
  axis that spans hosts.
* ``distributed/fusion.py``'s ladder arithmetic: ``resolve_hierarchical``
  over modes, inner sizes, the legacy boolean and topologies;
  ``hier_bucket_layout``, ``ef_residual_specs`` (the port's per-rank
  shapes are the JAX global shapes over the world) and
  ``hier_wire_summary`` over the JAX tests' shapes and thresholds.
* ``distributed/compression.py``: the int8 and fp8 codecs bit for bit
  against the JAX codecs (payload bytes, scale, dequantized values) on
  seeded float32 vectors with an all-zero shard and values at and past
  the cap.
* ``common/config.py``: the ``HOROVOD_HIERARCHICAL*`` knobs read as the
  JAX package reads them, bad values included.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.common import state as jstate
from horovod_tpu.common.exceptions import InvalidArgumentError as JErr
from horovod_tpu.jax import fusion as jf
from horovod_tpu.jax.compression import Compression as JC
from horovod_tpu.parallel import logical as jl
from horovod_tpu.parallel import mesh as jm
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.distributed import fusion as tf
from horovod_tpu_torch.distributed.compression import Compression as TC
from horovod_tpu_torch.parallel import logical as tl
from horovod_tpu_torch.parallel import mesh as tm

_SHAPES = [(33,), (7, 5), (101,), (4, 4, 4), (257,)]


class _FakeDev:
    """A device of the JAX side's fake topologies."""

    def __init__(self, i, process_index=0, slice_index=None):
        self.id = i
        self.process_index = process_index
        self.slice_index = slice_index

    def __repr__(self):
        return f"D{self.id}"


# (JAX devices, port host keys) of each topology: 8 ranks on one host,
# 2 hosts x 4, 4 hosts x 2, and a ragged 3 + 5.
def _topology(name):
    if name == "one_host":
        return list(jax.devices())[:8], ["h0"] * 8
    if name == "two_x4":
        return ([_FakeDev(i, slice_index=i // 4) for i in range(8)],
                [i // 4 for i in range(8)])
    if name == "four_x2":
        return ([_FakeDev(i, slice_index=i // 2) for i in range(8)],
                [i // 2 for i in range(8)])
    if name == "ragged":
        return ([_FakeDev(i, process_index=0 if i < 3 else 1)
                 for i in range(8)], [0] * 3 + [1] * 5)
    raise KeyError(name)


TOPOLOGIES = ["one_host", "two_x4", "four_x2", "ragged"]


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _spec(p):
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(p)


def _raises_alike(jfn, tfn):
    with pytest.raises(JErr) as want:
        jfn()
    with pytest.raises(InvalidArgumentError) as got:
        tfn()
    assert str(got.value) == str(want.value)


@pytest.fixture
def world():
    """A gloo world of one in this process (the knobs need init)."""
    basics.init(device="cpu")
    yield basics.config()
    basics.shutdown()


@contextlib.contextmanager
def _knobs(cfg, **kw):
    """Set the same knobs on the JAX config and the port's ``cfg``."""
    jcfg = jstate.global_state().config
    saved = {k: getattr(jcfg, k) for k in kw}
    try:
        for k, v in kw.items():
            setattr(jcfg, k, v)
            setattr(cfg, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(jcfg, k, v)


@contextlib.contextmanager
def _jax_devices(devices):
    st = jstate.global_state()
    saved = st.devices
    st.devices = devices
    try:
        yield
    finally:
        st.devices = saved


# ----------------------------------------------------------- config string


@pytest.mark.parametrize("config", [
    "tp=4,dp=8,sp=2", "dp=8", "zz=2,tp=4", "hvd=8", "dcn=2,ici=4",
    "ep=2, pp=2 ,dp=-1", "a=1,b=2,dp=2"])
def test_config_strings_round_trip_as_jax(config):
    assert tl.parse_mesh_config(config) == jl.parse_mesh_config(config)
    axes = tl.parse_mesh_config(config)
    assert tl.format_mesh_config(axes) == jl.format_mesh_config(axes)
    again = tl.parse_mesh_config(tl.format_mesh_config(axes))
    assert again == axes


@pytest.mark.parametrize("bad", [
    "", "   ", "dp", "dp=banana", "dp=0", "dp=-2", "dp=2,dp=4", "2=dp",
    "dp=2,,tp=2", None])
def test_bad_config_strings_raise_as_jax(bad):
    _raises_alike(lambda: jl.parse_mesh_config(bad),
                  lambda: tl.parse_mesh_config(bad))


# --------------------------------------------------------------- the mesh


AXES = [{"dp": 4, "tp": 2}, {"dp": 2, "tp": 4}, {"dp": 8},
        {"hvd": 8}, {"dp": -1, "tp": 2}, {"dp": 2, "tp": 2},
        {"tp": 2, "sp": 2, "dp": 2}]


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_logical_mesh_grid_and_resolution_equal_jax(hvd, axes):
    want = jl.LogicalMesh(dict(axes))
    got = tl.LogicalMesh(dict(axes), ranks=range(8), domains=["h"] * 8)
    np.testing.assert_array_equal(got.ranks, _ids(want.mesh))
    assert got.axes == want.axes and got.config == want.config
    assert got.axis_names == want.axis_names
    for name in ("dp", "tp", "sp", "hvd"):
        assert got.defines(name) == want.defines(name)
    for role in ("data", "tensor", "seq", "stage", "expert"):
        assert got.role_axis(role) == want.role_axis(role)
    for dims in (("batch",), ("heads",), ("mlp",), ("kv",), ("embed",),
                 ("seq",), ("batch", None, "heads"), ("vocab", "embed"),
                 ("expert", "stage"), ()):
        assert got.spec(*dims) == _spec(want.spec(*dims))


def test_logical_mesh_errors_equal_jax(hvd):
    dev = ["h"] * 8
    for jfn, tfn in (
            (lambda: jl.LogicalMesh({"dp": 8}).spec("hvd"),
             lambda: tl.LogicalMesh({"dp": 8}, ranks=range(8),
                                    domains=dev).spec("hvd")),
            (lambda: jl.LogicalMesh({"dp": 4, "tp": 2}).spec("heads",
                                                             "mlp"),
             lambda: tl.LogicalMesh({"dp": 4, "tp": 2}, ranks=range(8),
                                    domains=dev).spec("heads", "mlp")),
            (lambda: jl.LogicalMesh({"dp": 16}),
             lambda: tl.LogicalMesh({"dp": 16}, ranks=range(8),
                                    domains=dev)),
            (lambda: jl.LogicalMesh({"dp": -1, "tp": -1}),
             lambda: tl.LogicalMesh({"dp": -1, "tp": -1}, ranks=range(8),
                                    domains=dev)),
            (lambda: jl.LogicalMesh({"dp": -1, "tp": 3}),
             lambda: tl.LogicalMesh({"dp": -1, "tp": 3}, ranks=range(8),
                                    domains=dev)),
            (lambda: jl.LogicalMesh({}),
             lambda: tl.LogicalMesh({}, ranks=range(8), domains=dev)),
            (lambda: jl.LogicalMesh({"dp": 8}).role_axis("pipeline"),
             lambda: tl.LogicalMesh({"dp": 8}, ranks=range(8),
                                    domains=dev).role_axis("pipeline"))):
        _raises_alike(jfn, tfn)


def test_custom_rules_and_partition_specs_tree(hvd):
    rules = tuple(r for r in jl.DEFAULT_RULES if r[0] != "embed") + (
        ("embed", "tp"),)
    assert tl.DEFAULT_RULES == jl.DEFAULT_RULES
    want = jl.LogicalMesh({"dp": 4, "tp": 2}, rules=rules)
    got = tl.LogicalMesh({"dp": 4, "tp": 2}, rules=rules, ranks=range(8),
                         domains=["h"] * 8)
    assert got.spec("embed") == _spec(want.spec("embed")) == ("tp",)
    want = jl.LogicalMesh({"dp": 4, "tp": 2})
    got = tl.LogicalMesh({"dp": 4, "tp": 2}, ranks=range(8),
                         domains=["h"] * 8)
    tree = {"x": ("batch", "embed"), "w": ("embed", "mlp"),
            "layers": [("heads", None), ("kv",)]}
    jspecs = jl.logical_partition_specs(tree, want)
    tspecs = tl.logical_partition_specs(tree, got)
    assert tspecs == jax.tree_util.tree_map(
        _spec, jspecs, is_leaf=lambda x: isinstance(x, P))
    with pytest.raises(InvalidArgumentError, match="bind"):
        tl.logical_partition_specs(tree)
    with tl.bind(got):
        assert tl.logical_partition_specs(tree) == tspecs


def test_module_axis_and_bind_nesting_equal_jax(hvd):
    dev = ["h"] * 8
    for role in ("data", "tensor", "seq", "stage", "expert"):
        assert tl.module_axis(role) == jl.module_axis(role)
        assert tl.module_axis(role, "mine") == "mine"
    pairs = [(jl.LogicalMesh(a), tl.LogicalMesh(a, ranks=range(8),
                                                domains=dev))
             for a in ({"dp": 8}, {"tp": 8}, {"dp": 4, "tp": 2})]
    with jl.bind(pairs[0][0]), tl.bind(pairs[0][1]):
        assert tl.module_axis("data") == jl.module_axis("data") == "dp"
        with jl.bind(pairs[1][0]), tl.bind(pairs[1][1]):
            assert tl.current_logical_mesh() is pairs[1][1]
            assert tl.module_axis("tensor") == jl.module_axis("tensor")
            _raises_alike(lambda: jl.module_axis("data"),
                          lambda: tl.module_axis("data"))
            with jl.bind(pairs[2][0]), tl.bind(pairs[2][1]):
                for role in ("data", "tensor"):
                    assert tl.module_axis(role) == jl.module_axis(role)
        _raises_alike(lambda: jl.module_axis("tensor"),
                      lambda: tl.module_axis("tensor"))
    assert tl.current_logical_mesh() is None


@pytest.mark.parametrize("axes", [{"a": 8}, {"a": 2, "b": 4},
                                  {"a": -1, "b": 2}, {"a": 2, "b": 2,
                                                      "c": 2}], ids=str)
def test_make_mesh_grid_equals_jax(hvd, axes):
    want = jm.make_mesh(dict(axes), jax.devices()[:8])
    got = tm.make_mesh(dict(axes), range(8))
    np.testing.assert_array_equal(got.devices, _ids(want))
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)


def test_make_mesh_errors_equal_jax(hvd):
    for axes in ({"a": 3}, {"a": -1, "b": -1}, {"a": -1, "b": 3}):
        _raises_alike(lambda: jm.make_mesh(dict(axes), jax.devices()[:8]),
                      lambda: tm.make_mesh(dict(axes), range(8)))


@pytest.mark.parametrize("topology", ["one_host", "two_x4", "four_x2"])
def test_hybrid_mesh_and_logical_split_equal_jax(hvd, topology):
    devices, domains = _topology(topology)
    want = jm.hybrid_mesh(devices=devices)
    got = tm.hybrid_mesh(domains=domains)
    np.testing.assert_array_equal(got.devices, _ids(want))
    assert got.axis_names == tuple(want.axis_names)
    assert jm.slice_topology(devices) == tm.slice_topology(domains)
    assert jm.dcn_present(devices) == tm.dcn_present(domains)
    for axes in ({"dp": 2, "tp": 4}, {"dp": 4, "tp": 2},
                 {"dp": 2, "sp": 2, "tp": 2}):
        try:
            jlm = jl.LogicalMesh(dict(axes), devices=devices)
        except JErr:
            _raises_alike(
                lambda: jl.LogicalMesh(dict(axes), devices=devices),
                lambda: tl.LogicalMesh(dict(axes), ranks=range(8),
                                       domains=domains))
            continue
        tlm = tl.LogicalMesh(dict(axes), ranks=range(8), domains=domains)
        np.testing.assert_array_equal(tlm.ranks, _ids(jlm.mesh))
        assert tlm.axes == jlm.axes


def test_hybrid_mesh_of_shuffled_hosts_is_host_major(hvd):
    devices = [_FakeDev(i, slice_index=(1 - i // 4)) for i in range(8)]
    domains = [1 - i // 4 for i in range(8)]
    np.testing.assert_array_equal(
        tm.hybrid_mesh(domains=domains).devices,
        _ids(jm.hybrid_mesh(devices=devices)))


def test_ici_axis_spanning_hosts_and_ragged_topology_raise_as_jax(hvd):
    devices, domains = _topology("two_x4")
    _raises_alike(
        lambda: jm.hybrid_mesh(ici_axes={"ici": 8}, dcn_axes={"dcn": 1},
                               devices=devices),
        lambda: tm.hybrid_mesh(ici_axes={"ici": 8}, dcn_axes={"dcn": 1},
                               domains=domains))
    _raises_alike(
        lambda: jm.hybrid_mesh(ici_axes={"ici": 3}, devices=devices),
        lambda: tm.hybrid_mesh(ici_axes={"ici": 3}, domains=domains))
    _raises_alike(
        lambda: jl.LogicalMesh({"dp": 8}, devices=devices),
        lambda: tl.LogicalMesh({"dp": 8}, ranks=range(8), domains=domains))
    # A one-host set may factor freely.
    one = tm.hybrid_mesh(ici_axes={"ici": 2}, dcn_axes={"dcn": 4},
                         domains=["h"] * 8)
    assert one.devices.shape == (4, 2)
    devices, domains = _topology("ragged")
    _raises_alike(lambda: jm.slice_topology(devices),
                  lambda: tm.slice_topology(domains))
    assert tm.dcn_present(domains) and jm.dcn_present(devices)
    with pytest.raises(InvalidArgumentError, match="heterogeneous"):
        tm.hierarchical_mesh(range(8), domains=domains)


@pytest.mark.parametrize("inner", [None, 1, 2, 4, 8])
def test_hierarchical_mesh_and_ladder_groups_equal_jax(hvd, inner):
    # One process holds every JAX device, as one host holds every rank.
    want = jm.hierarchical_mesh(jax.devices()[:8], inner=inner)
    got = tm.hierarchical_mesh(range(8), inner=inner, domains=["h"] * 8)
    np.testing.assert_array_equal(got.devices, _ids(want))
    assert got.axis_names == tuple(want.axis_names)
    n = inner or 8
    assert tm.inner_groups(8, n) == jm.inner_groups(8, n)
    assert tm.outer_groups(8, n) == jm.outer_groups(8, n)


def test_hierarchical_mesh_errors_equal_jax(hvd):
    for inner in (3, 0, -2):
        _raises_alike(
            lambda: jm.hierarchical_mesh(jax.devices()[:8], inner=inner),
            lambda: tm.hierarchical_mesh(range(8), inner=inner,
                                         domains=["h"] * 8))


def test_ranks_per_host_and_domains_without_a_world():
    assert tm.rank_domains() == tm.rank_domains([0])
    assert len(tm.rank_domains([0, 1, 2])) == 3
    assert tm.world_ranks() == [0]
    assert tm.ranks_per_host([0, 0, 1], rank=0) == 2
    assert tm.ranks_per_host([0, 0, 1], rank=2) == 1


# ------------------------------------------------- resolve_hierarchical


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("inner", [0, 2, 3, 4, 8])
def test_resolve_hierarchical_equals_jax(hvd, world, topology, inner):
    devices, domains = _topology(topology)
    with _jax_devices(devices):
        for legacy in (False, True):
            for ambient in ("auto", "on", "off"):
                with _knobs(world, hierarchical_inner_size=inner,
                            hierarchical_allreduce=legacy,
                            hierarchical=ambient):
                    for mode in ("auto", "on", "off", True, False, None):
                        for axis in (8, 4, 16):
                            want = jf.resolve_hierarchical(mode, axis)
                            got = tf.resolve_hierarchical(mode, axis,
                                                          domains)
                            if (topology, inner) == ("ragged", 0) and \
                                    tf.resolve_hierarchical(
                                        mode, 3 * axis, domains):
                                # "on" with no inner size on ragged
                                # hosts: the JAX side falls back to its
                                # harness's 8 chips a process, the port
                                # to rank 0's 3 ranks on its host.
                                want = 3 if axis % 3 == 0 else 0
                            assert got == want, (mode, axis, legacy,
                                                 ambient)


def test_resolve_hierarchical_rejects_what_jax_rejects(hvd, world):
    _raises_alike(lambda: jf.resolve_hierarchical("sometimes", 8),
                  lambda: tf.resolve_hierarchical("sometimes", 8, [0] * 8))


# ---------------------------------------------- layouts and wire bytes


THRESHOLDS = [400, 10**9, 64, 140]
DTYPES = {
    "f32": ([jnp.float32] * 5, [torch.float32] * 5),
    "mixed": ([jnp.float32, jnp.bfloat16, jnp.float32, jnp.int32,
               jnp.bfloat16],
              [torch.float32, torch.bfloat16, torch.float32, torch.int32,
               torch.bfloat16]),
}


@pytest.mark.parametrize("elems", [1, 7, 33, 400, 1028, 4097])
def test_hier_bucket_layout_equals_jax(elems):
    for axis, inner in ((8, 4), (8, 2), (16, 4), (12, 3), (4, 2)):
        for q in (False, True):
            assert tf.hier_bucket_layout(elems, axis, inner, q) == \
                jf.hier_bucket_layout(elems, axis, inner, q)


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("dtypes", list(DTYPES))
def test_ef_residual_specs_are_the_jax_shapes_over_the_world(threshold,
                                                             dtypes):
    jdt, tdt = DTYPES[dtypes]
    jleaves = [jax.ShapeDtypeStruct(s, d) for s, d in zip(_SHAPES, jdt)]
    tleaves = [torch.empty(s, dtype=d, device="meta")
               for s, d in zip(_SHAPES, tdt)]
    for axis, inner in ((8, 4), (8, 2), (16, 4)):
        want = jf.ef_residual_specs(jleaves, threshold, axis, inner)
        got = tf.ef_residual_specs(tleaves, threshold, axis, inner)
        assert [(axis * s.shape[0],) for s in got] == \
            [tuple(s.shape) for s in want]
        assert all(s.dtype == torch.float32 for s in got)


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("comp", ["none", "fp16", "bf16", "int8", "fp8"])
def test_hier_wire_summary_equals_jax(threshold, dtypes, comp):
    jdt, tdt = DTYPES[dtypes]
    jcomp, tcomp = getattr(JC, comp), getattr(TC, comp)
    jleaves = [jax.ShapeDtypeStruct(s, jcomp.plan_dtype(jnp.dtype(d)))
               for s, d in zip(_SHAPES, jdt)]
    tleaves = [torch.empty(s, dtype=tcomp.plan_dtype(d), device="meta")
               for s, d in zip(_SHAPES, tdt)]
    jplan = jf.plan_buckets(jleaves, threshold)
    tplan = tf.plan_buckets(tleaves, threshold)
    assert [tuple(b) for b in tplan] == [tuple(b) for b in jplan]
    for axis, inner in ((8, 4), (8, 2), (16, 4)):
        assert tf.hier_wire_summary(tplan, axis, inner, tcomp) == \
            jf.hier_wire_summary(jplan, axis, inner, jcomp)


# ------------------------------------------------------------- the codecs


def _codec_inputs():
    rng = np.random.default_rng(12)
    return {
        "normal": rng.standard_normal(4099).astype(np.float32) * 3,
        "tiny": rng.standard_normal(257).astype(np.float32) * 1e-30,
        "zeros": np.zeros(64, np.float32),
        "at_cap": np.array([127, -127, 448, -448, 0.5, -0.5, 1],
                           np.float32),
        "past_cap": np.array([1e4, -3e5, 449, 128, -1, 0, 2.5, -2.5],
                             np.float32),
        "halves": (np.arange(-40, 41, dtype=np.float32) + 0.5) / 2,
    }


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("case", list(_codec_inputs()))
def test_codecs_equal_jax_bit_for_bit(name, case):
    v = _codec_inputs()[case]
    jc, tc = getattr(JC, name), getattr(TC, name)
    jq, js = jc.quantize(jnp.asarray(v))
    tq, ts = tc.quantize(torch.tensor(v))
    assert tq.dtype == tc.wire_dtype and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.wire_view(tq).numpy(),
                                  np.asarray(jq).view(np.uint8))
    assert np.float32(ts.item()).tobytes() == np.float32(js).tobytes()
    np.testing.assert_array_equal(tc.dequantize(tq, ts).numpy(),
                                  np.asarray(jc.dequantize(jq, js)))
    # The protocol methods are identity: nothing is cast at bucketing.
    t = torch.tensor(v)
    c, ctx = tc.compress(t)
    assert c is t and tc.decompress(c, ctx) is t
    assert tc.plan_dtype(torch.bfloat16) == torch.bfloat16


def test_is_dcn_wire_marks_only_the_low_bit_codecs():
    from horovod_tpu.jax.compression import is_dcn_wire as j_is
    from horovod_tpu_torch.distributed.compression import is_dcn_wire

    for name in ("none", "fp16", "bf16", "int8", "fp8"):
        assert is_dcn_wire(getattr(TC, name)) == j_is(getattr(JC, name))


# --------------------------------------------------------------- the knobs


@pytest.mark.parametrize("env", [
    {},
    {"HOROVOD_HIERARCHICAL": "ON", "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
     "HOROVOD_HIERARCHICAL_ALLGATHER": "true",
     "HOROVOD_HIERARCHICAL_INNER_SIZE": "4"},
    {"HOROVOD_HIERARCHICAL": " off ", "HOROVOD_HIERARCHICAL_ALLREDUCE": "0",
     "HOROVOD_HIERARCHICAL_ALLGATHER": "FALSE"},
    {"HOROVOD_HIERARCHICAL": "sometimes",
     "HOROVOD_HIERARCHICAL_INNER_SIZE": "two",
     "HOROVOD_HIERARCHICAL_ALLGATHER": ""},
], ids=["defaults", "set", "off", "bad_values"])
def test_hierarchical_knobs_read_as_jax(monkeypatch, env):
    from horovod_tpu.common.config import HIERARCHICAL_MODES
    from horovod_tpu.common.config import Config as JConfig
    from horovod_tpu_torch.common import config as tcfg

    for k in ("HOROVOD_HIERARCHICAL", "HOROVOD_HIERARCHICAL_ALLREDUCE",
              "HOROVOD_HIERARCHICAL_ALLGATHER",
              "HOROVOD_HIERARCHICAL_INNER_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, got = JConfig.from_env(), tcfg.Config.from_env()
    for field in ("hierarchical", "hierarchical_allreduce",
                  "hierarchical_allgather", "hierarchical_inner_size"):
        assert getattr(got, field) == getattr(want, field), field
    assert tcfg.HIERARCHICAL_MODES == HIERARCHICAL_MODES

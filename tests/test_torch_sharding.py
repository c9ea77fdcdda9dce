"""The port's sharding rules and meshes against the reference, on the CPU.

``repro_torch.models.sharding`` is the reference's rule table as pure
functions on shapes: ``param_specs`` and ``cache_specs`` are held ``==`` to
``repro.models.sharding``'s for all ten archs at their published widths,
the four modes and the meshes ``16x16``, ``2x16x16`` and ``dp`` 1, 2, 8
and 256 (mesh sizes set with the reference's ``set_mesh_sizes``; no device
is needed).  A spec is compared as a ``PartitionSpec`` built from the
port's tuple, since jax takes a one-axis tuple entry and its axis name as
equal.  ``shard_shape`` and the meshes are checked by hand.
"""
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro.models import sharding as jshd
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import sharding as tshd
from repro_torch.models import transformer as T

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "dp1": {"data": 1}, "dp2": {"data": 2}, "dp8": {"data": 8}, "dp256": {"data": 256}}
MODES = ("fsdp", "fsdp2d", "zero3", "pure_dp")
DECODE_SHAPES = ("decode_32k", "long_500k")


def _ref_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): tuple(spec)
            for path, spec in leaves}


def _port_specs(tree) -> dict:
    return {path: tuple(P(*spec)) for path, spec in T.leaf_order(tree)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jsteps.params_shape(jax_get_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, shape):
    return jsteps.input_specs(jax_get_config(arch), JSHAPES[shape])["cache"]


def _cases():
    for name, sizes in MESHES.items():
        for mode in MODES:
            yield name, sizes, mode


class TestSpecsAgainstReference:
    def test_the_port_has_the_reference_archs(self):
        assert ARCH_IDS == JARCH_IDS

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_param_specs_equal_reference(self, arch):
        ours = tsteps.init_params(get_config(arch), device="meta")
        for name, sizes, mode in _cases():
            sc_j = jshd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
            sc_t = tshd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
            token = jshd.set_mesh_sizes(sizes)
            try:
                want = _ref_specs(jshd.param_specs(_ref_params(arch), sc_j))
            finally:
                jshd._MESH_SIZES.reset(token)
            got = _port_specs(tshd.param_specs(ours, sc_t, sizes=sizes))
            assert got == want, (arch, name, mode)

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_cache_specs_equal_reference(self, arch):
        cfg = get_config(arch)
        for shape in DECODE_SHAPES:
            shp = SHAPES[shape]
            ours = T.init_cache(cfg, shp.global_batch, shp.seq_len, device="meta")
            for name, sizes, mode in _cases():
                sc_j = jshd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
                token = jshd.set_mesh_sizes(sizes)
                try:
                    want = _ref_specs(jshd.cache_specs(_ref_cache(arch, shape), sc_j))
                finally:
                    jshd._MESH_SIZES.reset(token)
                sc_t = tshd.ShardingConfig(mesh_axes=tuple(sizes), mode=mode)
                # the sizes set for the context, as the reference sets them
                tok = tshd.set_mesh_sizes(sizes)
                try:
                    got = _port_specs(tshd.cache_specs(ours, sc_t))
                finally:
                    tshd._MESH_SIZES.reset(tok)
                assert got == want, (arch, shape, name, mode)

    @pytest.mark.parametrize("mesh", tuple(MESHES))
    def test_config_axes_and_dp_axes_equal_reference(self, mesh):
        axes = tuple(MESHES[mesh])
        for mode in MODES:
            j, t = jshd.ShardingConfig(axes, mode), tshd.ShardingConfig(axes, mode)
            for logical in ("batch", "fsdp", "tensor", "expert", "seq", None):
                assert t._axis(logical) == j._axis(logical), (mesh, mode, logical)
            assert t.dp_axes == j.dp_axes
            assert tuple(P(*t.spec("batch", None, "tensor"))) == \
                tuple(j.spec("batch", None, "tensor"))

    @pytest.mark.parametrize("mesh", tuple(MESHES))
    def test_batch_leaf_resolution_equals_reference(self, mesh):
        sizes = MESHES[mesh]
        for mode in MODES:
            sc_j, sc_t = jshd.ShardingConfig(tuple(sizes), mode), \
                tshd.ShardingConfig(tuple(sizes), mode)
            for dims in ((256, 4096), (32, 32768), (128,), (1,), (128, 1500, 384), ()):
                cands = [["batch"]] + [()] * (len(dims) - 1) if dims else []
                token = jshd.set_mesh_sizes(sizes)
                try:
                    want = tuple(jshd.resolve_spec(dims, cands, sc_j))
                finally:
                    jshd._MESH_SIZES.reset(token)
                assert tuple(P(*tshd.resolve_spec(dims, cands, sc_t, sizes))) == want


class TestShapesAndMeshes:
    def test_shard_shape(self):
        sizes = {"pod": 2, "data": 16, "model": 16}
        assert tshd.shard_shape((256, 4096), (("pod", "data"), None), sizes) == (8, 4096)
        assert tshd.shard_shape((64, 128), ("model", None), sizes) == (4, 128)
        assert tshd.shard_shape((3, 5), (None, None), sizes) == (3, 5)
        assert tshd.shard_shape((), (), sizes) == ()
        with pytest.raises(ValueError):
            tshd.shard_shape((30,), ("model",), sizes)

    def test_pure_dp_replicates_parameters_and_splits_the_batch(self):
        cfg = get_config("qwen1.5-4b")
        sizes = tmesh.dp_mesh_sizes(8)
        sc = tshd.ShardingConfig(tuple(sizes), "pure_dp")
        specs = tshd.param_specs(T.init_lm(cfg, device="meta"), sc, sizes=sizes)
        assert all(all(e is None for e in s) for _, s in T.leaf_order(specs))
        assert tshd.resolve_spec((256, 4096), [["batch"], ()], sc, sizes) == (("data",), None)
        assert tshd.resolve_spec((32, 32768), [["batch"], ()], tshd.ShardingConfig(
            ("data",), "pure_dp"), tmesh.dp_mesh_sizes(256)) == (None, None)

    def test_meshes_equal_the_reference_layouts(self):
        assert tmesh.production_mesh_sizes() == {"data": 16, "model": 16}
        assert tmesh.production_mesh_sizes(multi_pod=True) == \
            {"pod": 2, "data": 16, "model": 16}
        assert tmesh.dp_mesh_sizes(4) == {"data": 4}
        assert [tmesh.mesh_label(s) for s in MESHES.values()] == list(MESHES)
        with pytest.raises(ValueError):
            tmesh.dp_mesh_sizes(0)

    def test_fake_process_group_starts_and_is_always_destroyed(self):
        import torch.distributed as dist

        with tmesh.fake_process_group(4) as group:
            assert dist.get_world_size(group) == 4 and dist.get_rank() == 0
        assert not dist.is_initialized()
        with pytest.raises(KeyError):
            with tmesh.fake_process_group(2):
                raise KeyError("inside")
        assert not dist.is_initialized()

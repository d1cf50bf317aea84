"""The port's sharding rules (``models/params.py::resolve_spec``,
``parallel/sharding.py``, ``launch/mesh.py``) against the JAX package's.

For every architecture and shape kind, on the reference's two production
mesh sizes, the port's rules and specs equal ``tuple()`` of the reference's
``PartitionSpec`` exactly (they are names, not numbers: no tolerance). A
duck-typed mesh that carries only the axis names and sizes serves both
packages' ``make_rules``. ``tree_shardings`` is checked on a 256- and a
512-rank ``DeviceMesh`` of torch's fake process-group backend (one process,
no communication): each leaf's local shard shape is its global shape divided
as the reference's spec says, and a dim sharded over ("pod", "data") is
split pod-major.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402

from repro.configs import ARCHITECTURES, get_config  # noqa: E402
from repro.models import SHAPES, cache_descs, param_descs  # noqa: E402
from repro.models.params import PDesc as RefPDesc  # noqa: E402
from repro.models.params import is_desc as ref_is_desc  # noqa: E402
from repro.models.params import resolve_spec as ref_resolve_spec  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

MESHES = {"pod1": {"data": 16, "model": 16}, "pod2": {"pod": 2, "data": 16, "model": 16}}


def _meshes(sizes):
    """Duck-typed meshes: the reference's reads ``axis_names``, the port's
    ``mesh_dim_names`` and ``shape``."""
    names = tuple(sizes)
    return (SimpleNamespace(axis_names=names),
            SimpleNamespace(mesh_dim_names=names, shape=tuple(sizes.values())))


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=ref_is_desc)


def _desc_trees(arch, shape):
    """The reference's and the port's configs and descriptor trees: the
    params, the batch inputs and, for decode shapes, the cache."""
    cfg, pcfg = get_config(arch), port_get_config(arch)
    ref = [param_descs(cfg), ref_sharding.batch_input_descs(cfg, shape)]
    port = [tm.param_descs(pcfg), sharding.batch_input_descs(pcfg, shape)]
    if shape.kind == "decode":
        ref.append(cache_descs(cfg, batch=shape.global_batch, max_len=shape.seq_len))
        port.append(tm.cache_descs(pcfg, batch=shape.global_batch, max_len=shape.seq_len))
    return cfg, pcfg, ref, port


def _desc_pairs(arch, shape):
    """(reference desc, port desc) for every leaf of ``_desc_trees``, in
    flatten order."""
    cfg, pcfg, ref, port = _desc_trees(arch, shape)
    pairs = []
    for r, p in zip(ref, port):
        rl, pl = _ref_leaves(r), tree_flatten(p)[0]
        assert len(rl) == len(pl)
        pairs += list(zip(rl, pl))
    return cfg, pcfg, pairs


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_profile_and_specs_equal_reference(arch, mesh_name):
    sizes = MESHES[mesh_name]
    ref_mesh, port_mesh = _meshes(sizes)
    assert sharding.mesh_axis_sizes(port_mesh) == sizes
    for shape in SHAPES:
        cfg, pcfg, pairs = _desc_pairs(arch, shape)
        ref_prof = ref_sharding.profile_for(cfg, shape, ref_mesh)
        prof = sharding.profile_for(pcfg, shape, port_mesh)
        assert (prof.name, prof.rules) == (ref_prof.name, ref_prof.rules)
        for rd, pd in pairs:
            assert (pd.shape, pd.axes) == (rd.shape, rd.axes)
            want = tuple(ref_resolve_spec(rd, ref_prof.rules, sizes))
            assert tm.resolve_spec(pd, prof.rules, sizes) == want, (arch, shape.name, pd)


def _walk(tree):
    """Leaves of a nested dict in sorted-key order (a spec tree's leaves are
    tuples, which ``tree_flatten`` would descend into)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "llama_3p2_vision_90b"])
def test_resolve_specs_and_param_bytes_equal_reference(arch):
    from repro.models.params import param_bytes, resolve_specs

    cfg, pcfg = get_config(arch), port_get_config(arch)
    sizes = MESHES["pod2"]
    rules = ref_sharding.make_rules(_meshes(sizes)[0], kind="train", fsdp=True).rules
    want = jax.tree_util.tree_leaves(resolve_specs(param_descs(cfg), rules, sizes),
                                     is_leaf=lambda x: isinstance(x, PartitionSpec))
    got = list(_walk(tm.resolve_specs(tm.param_descs(pcfg), rules, sizes)))
    assert got == [tuple(s) for s in want]
    for b in (2, 4):
        assert tm.param_bytes(tm.param_descs(pcfg), b) == param_bytes(param_descs(cfg), b)


class TestSpecResolution:
    """Twins of tests/test_analysis.py::TestSpecResolution."""

    def test_divisibility_fallback(self):
        sizes = {"data": 16, "model": 16}
        rules = {"kv_heads": ("model",), "seq": ("model",), "batch": ("data",)}
        # kv=4 does not divide 16 -> seq takes the model axis
        d = tm.PDesc((128, 32768, 4, 128), ("batch", "seq", "kv_heads", None))
        assert tm.resolve_spec(d, rules, sizes) == ("data", "model")
        # kv=32 divides -> kv wins over seq (priority)
        d2 = tm.PDesc((128, 32768, 32, 128), ("batch", "seq", "kv_heads", None))
        assert tm.resolve_spec(d2, rules, sizes) == ("data", None, "model")

    @pytest.mark.parametrize("dim", [1, 2, 3, 4, 8, 16, 40, 64, 100, 256])
    @pytest.mark.parametrize("model", [1, 2, 4, 8, 16])
    def test_resolution_equals_reference_and_divides(self, dim, model):
        sizes = {"model": model, "data": 4}
        rules = {"x": ("model",), "batch": ("data", "model")}
        for shape, axes in (((dim,), ("x",)), ((dim, 8), ("batch", "x")),
                            ((8, dim), ("x", "batch"))):
            spec = tm.resolve_spec(tm.PDesc(shape, axes), rules, sizes)
            assert spec == tuple(ref_resolve_spec(RefPDesc(shape, axes), rules, sizes))
        spec = tm.resolve_spec(tm.PDesc((dim,), ("x",)), rules, sizes)
        if spec and spec[0] is not None:
            assert dim % model == 0


# --------------------------------------------------------------------------- #
# tree_shardings on a fake-backend DeviceMesh                                  #
# --------------------------------------------------------------------------- #
#: this process's coordinates on each mesh: not rank 0, so that the pod-major
#: order of a ("pod", "data") dim shows in the shard's content
COORDS = {"pod1": (3, 5), "pod2": (1, 3, 5)}


@pytest.fixture(params=sorted(MESHES))
def fake_mesh(request):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sizes = MESHES[request.param]
    coord = COORDS[request.param]
    rank = int(np.ravel_multi_index(coord, tuple(sizes.values())))
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=int(np.prod(list(sizes.values()))))
    try:
        mesh = make_production_mesh(multi_pod="pod" in sizes, device_type="cpu")
        assert mesh.mesh_dim_names == tuple(sizes) and tuple(mesh.get_coordinate()) == coord
        yield request.param, sizes, mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v2_lite_16b",
                                  "llama_3p2_vision_90b", "seamless_m4t_large_v2"])
def test_tree_shardings_local_shapes(fake_mesh, arch):
    name, sizes, mesh = fake_mesh
    ref_mesh = _meshes(sizes)[0]
    for shape in SHAPES:
        cfg, pcfg, ref_trees, port_trees = _desc_trees(arch, shape)
        ref_rules = ref_sharding.profile_for(cfg, shape, ref_mesh).rules
        prof = sharding.profile_for(pcfg, shape, mesh)
        for ref_tree, port_tree in zip(ref_trees, port_trees):
            placed = list(_walk(sharding.tree_shardings(port_tree, prof, mesh)))
            descs = tree_flatten(port_tree)[0]
            assert len(placed) == len(descs)
            for rd, d, pl in zip(_ref_leaves(ref_tree), descs, placed):
                assert len(pl) == len(sizes)
                assert all(isinstance(x, (Shard, Replicate)) for x in pl)
                spec = tuple(ref_resolve_spec(rd, ref_rules, sizes))
                want = list(d.shape)
                for i, entry in enumerate(spec):
                    for a in ((entry,) if isinstance(entry, str) else entry or ()):
                        want[i] //= sizes[a]
                local = distribute_tensor(torch.empty(d.shape, device="meta"), mesh, list(pl))
                assert tuple(local.to_local().shape) == tuple(want), (arch, shape.name, d, spec)


def test_batch_dim_over_pod_and_data_splits_pod_major(fake_mesh):
    name, sizes, mesh = fake_mesh
    prof = sharding.make_rules(mesh, kind="train")
    (pl,) = list(_walk(sharding.tree_shardings(
        {"t": tm.PDesc((64, 32), ("batch", None))}, prof, mesh)))
    n_batch = 32 if name == "pod2" else 16
    assert pl == ((Shard(0), Shard(0), Replicate()) if name == "pod2"
                  else (Shard(0), Replicate()))
    rows = torch.arange(64.)[:, None].expand(64, 32).contiguous()
    local = distribute_tensor(rows, mesh, list(pl), src_data_rank=None).to_local()
    coord = COORDS[name]
    index = coord[0] * 16 + coord[1] if name == "pod2" else coord[0]
    per = 64 // n_batch
    assert torch.equal(local[:, 0], torch.arange(index * per, (index + 1) * per, dtype=torch.float32))
    backwards = ("data", "pod") if name == "pod2" else ("model", "data")
    with pytest.raises(ValueError, match="mesh's axis order"):
        sharding.placements((backwards,), mesh)


def test_batch_dtypes_and_host_mesh(tmp_path):
    assert sharding.batch_dtypes(port_get_config("seamless_m4t_large_v2")) == {
        "tokens": torch.int32, "frames": torch.bfloat16}
    assert sharding.batch_dtypes(port_get_config("llama_3p2_vision_90b")) == {
        "tokens": torch.int32, "image_embeds": torch.bfloat16}
    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(model=1, device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(model=2, device_type="cpu")
    finally:
        dist.destroy_process_group()

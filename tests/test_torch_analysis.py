"""The port's analytic cost model (``analysis/roofline.py``,
``analysis/memory_est.py``) and int8 gradient compression
(``optim/compress.py``) against the JAX package's.

The counts are integers and products of integers held in floats: they must
be equal, not close (no tolerance). ``roofline_terms`` is given one ``hw``
dict holding both packages' keys, so the two divide by the same rates.
The compression runs three steps of error feedback on the CPU and must be
bit-equal in codes, scales and residuals (both round half to even).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import memory_est as ref_mem  # noqa: E402
from repro.analysis import roofline as ref_roof  # noqa: E402
from repro.configs import ARCHITECTURES, get_config  # noqa: E402
from repro.launch.mesh import TPU_V5E  # noqa: E402
from repro.models import SHAPES  # noqa: E402
from repro.models.tuning import tuning as ref_tuning  # noqa: E402
from repro.optim import compress_gradients_int8 as ref_compress  # noqa: E402
from repro.optim import decompress_gradients_int8 as ref_decompress  # noqa: E402
from repro.parallel.sharding import profile_for as ref_profile_for  # noqa: E402
from repro_torch.analysis import memory_est, roofline  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.launch.mesh import H100_SXM  # noqa: E402
from repro_torch.models import tuning  # noqa: E402
from repro_torch.optim import compress_gradients_int8, decompress_gradients_int8  # noqa: E402
from repro_torch.parallel.sharding import profile_for  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402
from test_torch_sharding import MESHES, _meshes  # noqa: E402


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_model_flops_and_roofline_terms_equal_reference(arch):
    cfg, pcfg = get_config(arch), port_get_config(arch)
    assert roofline.active_param_count(pcfg) == ref_roof.active_param_count(cfg)
    hw = {**TPU_V5E, **H100_SXM, "ici_link_bw": H100_SXM["nvlink_bw"]}
    for shape in SHAPES:
        assert roofline.model_flops(pcfg, shape) == ref_roof.model_flops(cfg, shape)
        for cost, coll in (({"flops": 1e14, "bytes accessed": 1e12}, {"total": 1e10}),
                           ({"flops": 3e12, "bytes accessed": 4e12}, {"total": 5e12}),
                           ({}, {})):
            want = ref_roof.roofline_terms(cost, coll, cfg, shape, chips=256, hw=hw)
            assert roofline.roofline_terms(cost, coll, pcfg, shape, chips=256, hw=hw) == want


def test_roofline_defaults_to_the_h100():
    cfg = port_get_config("yi_6b")
    shape = SHAPES[0]
    t = roofline.roofline_terms({"flops": 1e14, "bytes accessed": 1e12}, {"total": 1e10},
                                cfg, shape, chips=256)
    assert t["compute_s"] == 1e14 / 989e12
    assert t["memory_s"] == 1e12 / 3.35e12
    assert t["collective_s"] == 1e10 / 900e9
    assert t["dominant"] == "memory"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_estimate_hbm_byte_terms_equal_reference(arch, mesh_name):
    """Every byte term (everything but the hardware's fraction and fit),
    under each remat policy and with the tuning knobs the terms read."""
    cfg, pcfg = get_config(arch), port_get_config(arch)
    sizes = MESHES[mesh_name]
    ref_mesh, port_mesh = _meshes(sizes)
    for shape in SHAPES:
        rules = profile_for(pcfg, shape, port_mesh).rules
        assert rules == ref_profile_for(cfg, shape, ref_mesh).rules
        for remat in ("full", "dots", "none"):
            for knobs in ({}, {"microbatch": 2, "loss_chunk": 512}):
                with ref_tuning(**knobs):
                    want = ref_mem.estimate_hbm(cfg, shape, rules, sizes, remat)
                with tuning(**knobs):
                    got = memory_est.estimate_hbm(pcfg, shape, rules, sizes, remat)
                hw_keys = {"hbm_fraction", "fits_16g", "fits_hbm"}
                assert {k: v for k, v in got.items() if k not in hw_keys} == \
                    {k: v for k, v in want.items() if k not in hw_keys}
                assert got["hbm_fraction"] == got["total"] / 80e9
                assert got["fits_hbm"] == (got["total"] <= 80e9)
            if shape.kind != "train":
                break  # remat and the knobs change only the train terms


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((64, 64)).astype(np.float32),
            "b": {"c": (rng.standard_normal((8,)) * 1e-3).astype(np.float32),
                  "d": np.zeros((3, 5), np.float32)}}


def test_compress_bit_equal_to_reference_over_three_steps():
    """A twin of tests/test_training.py::test_gradient_compression_error_feedback:
    three steps of error feedback (a zero tensor among the leaves), codes,
    scales, residuals and the decompressed tree bit-equal."""
    steps = [_grads(s) for s in range(3)]
    ef_ref = jax.tree_util.tree_map(lambda g: jnp.zeros_like(g), steps[0])
    ef = {"a": torch.zeros(64, 64), "b": {"c": torch.zeros(8), "d": torch.zeros(3, 5)}}
    for g in steps:
        codes_r, scales_r, ef_ref = ref_compress(jax.tree_util.tree_map(jnp.asarray, g), ef_ref)
        codes, scales, ef = compress_gradients_int8(
            jax.tree_util.tree_map(torch.from_numpy, g), ef)
        deq_r = ref_decompress(codes_r, scales_r)
        deq = decompress_gradients_int8(codes, scales)
        for mine, ref in ((codes, codes_r), (scales, scales_r), (ef, ef_ref), (deq, deq_r)):
            got = [t.numpy() for t in tree_flatten(mine)[0]]
            want = [np.asarray(t) for t in jax.tree_util.tree_leaves(ref)]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
    assert tree_flatten(codes)[0][0].dtype == torch.int8

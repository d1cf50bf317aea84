"""Checkpoint blobs interchange between the port and the JAX package.

The port's ``DeltaCheckpointCodec`` writes the reference's format, so a
base and a delta written by one side decode with the other's
``decode_chain``: same blob keys, base parameters exact, delta parameters
within half a quantisation step per block, optimizer leaves as stored.
"""
from __future__ import annotations

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.checkpoint.delta import DeltaCheckpointCodec as JaxCodec  # noqa: E402
from repro.checkpoint.delta import _flatten as jax_flatten  # noqa: E402
from repro_torch.checkpoint.delta import DeltaCheckpointCodec, _flatten  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402


def _state(seed: int, scale: float = 1.0):
    """A params tree whose stream spans 4 blocks (the last one padded) and
    an AdamW-shaped state: m that fp16 holds, v that it does not."""
    rng = np.random.default_rng(seed)
    params = {
        "b": {"w": (rng.standard_normal((40, 64)) * scale).astype(np.float32)},
        "a": (rng.standard_normal((1000,)) * scale).astype(np.float32),
    }
    m = jax.tree_util.tree_map(lambda p: (0.01 * p).astype(np.float32), params)
    v = jax.tree_util.tree_map(lambda p: (1e-9 * p * p).astype(np.float32), params)
    return params, {"m": m, "v": v, "step": np.array(seed, np.int32)}


def _step(state, seed):
    params, opt = state
    rng = np.random.default_rng(100 + seed)
    new = jax.tree_util.tree_map(
        lambda p: (p + 1e-3 * rng.standard_normal(p.shape)).astype(np.float32), params)
    return new, opt


def _keys(blob: bytes):
    return sorted(np.load(io.BytesIO(blob)).files)


def _to_port(state):
    return params_from_jax(state[0], device="cpu"), params_from_jax(state[1], device="cpu")


def _decode_jax(blobs, like):
    _, ps, pd = jax_flatten(like[0])
    _, os_, od = jax_flatten(like[1])
    (params, opt), _ = JaxCodec().decode_chain(blobs, ps, pd, os_, od)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)], \
        [np.asarray(x) for x in jax.tree_util.tree_leaves(opt)]


def _decode_port(blobs, like):
    like_t = _to_port(like)
    _, ps, pd = _flatten(like_t[0])
    _, os_, od = _flatten(like_t[1])
    (params, opt), _ = DeltaCheckpointCodec().decode_chain(blobs, ps, pd, os_, od, "cpu")
    return [t.numpy() for t in tree_flatten(params)[0]], [t.numpy() for t in tree_flatten(opt)[0]]


def _check(decoded, base_state, new_state, delta_blob):
    params, opt = decoded
    scales = np.load(io.BytesIO(delta_blob))["scales"]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(new_state[0])]
    flat_err = np.concatenate([np.abs(g - w).ravel() for g, w in zip(params, want)])
    err = np.zeros(len(scales) * 1024, np.float32)
    err[: flat_err.size] = flat_err
    # codec bound: half a quantisation step of each 1024-value block
    assert (err.reshape(-1, 1024) <= scales[:, None] * 0.51 + 1e-7).all()
    stored = np.load(io.BytesIO(delta_blob))
    for i, (got, leaf) in enumerate(zip(opt, jax.tree_util.tree_leaves(new_state[1]))):
        np.testing.assert_array_equal(got, stored[f"o{i}"].astype(np.asarray(leaf).dtype))


def test_port_blobs_decode_with_jax_codec():
    s0 = _state(1)
    s1 = _step(s0, 1)
    codec = DeltaCheckpointCodec()
    base, flat0 = codec.encode(0, _to_port(s0), None)
    delta, _ = codec.encode(1, _to_port(s1), flat0)
    jb, jflat0 = JaxCodec().encode(0, s0, None)
    jd, _ = JaxCodec().encode(1, s1, jflat0)
    assert _keys(base) == _keys(jb) and _keys(delta) == _keys(jd)
    assert _keys(delta) == ["codes", "kind", "n", "o0", "o1", "o2", "o3", "o4", "scales"]
    # the fp16 policy picks the same representation per leaf (m*, step, v*)
    for k in ("o0", "o1", "o2", "o3", "o4"):
        assert np.load(io.BytesIO(delta))[k].dtype == np.load(io.BytesIO(jd))[k].dtype
    params, _ = _decode_jax([base], s0)
    for got, want in zip(params, jax.tree_util.tree_leaves(s0[0])):
        np.testing.assert_array_equal(got, want)
    _check(_decode_jax([base, delta], s0), s0, s1, delta)


def test_jax_blobs_decode_with_port_codec():
    s0 = _state(2)
    s1 = _step(s0, 2)
    jb, jflat0 = JaxCodec().encode(0, s0, None)
    jd, _ = JaxCodec().encode(1, s1, jflat0)
    params, _ = _decode_port([jb], s0)
    for got, want in zip(params, jax.tree_util.tree_leaves(s0[0])):
        np.testing.assert_array_equal(got, want)
    _check(_decode_port([jb, jd], s0), s0, s1, jd)


def test_codec_stream_matches_jax_flatten():
    """Flatten order and stream are the reference's: sorted keys, f32."""
    s0 = _state(3)
    flat_j, _, _ = jax_flatten(s0)
    flat_t, shapes, _ = _flatten(_to_port(s0))
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    assert shapes[0] == ((1000,), torch.float32)


def _model_state(arch: str):
    """The smoke config's JAX-initialised params (gemma3's nested group
    stacks, mamba2's mixer leaves) and an AdamW-shaped state."""
    from repro.configs import get_config
    from repro.models import init_params, param_descs

    cfg = get_config(arch, smoke=True)
    params = jax.tree_util.tree_map(
        np.asarray, init_params(param_descs(cfg), jax.random.key(0), np.float32))
    m = jax.tree_util.tree_map(lambda p: (0.01 * p).astype(np.float32), params)
    v = jax.tree_util.tree_map(lambda p: (1e-9 * p * p).astype(np.float32), params)
    return params, {"m": m, "v": v, "step": np.array(3, np.int32)}


@pytest.mark.parametrize("arch", ["gemma3_4b", "mamba2_370m"])
def test_model_blobs_interchange(arch):
    """Blobs of a model's state: the reference's decode in the port, the
    port's in the reference; the flat stream of the nested stacks is the
    reference's sorted-key order."""
    s0 = _model_state(arch)
    s1 = _step(s0, 4)
    flat_j, _, _ = jax_flatten(s0)
    flat_t, _, _ = _flatten(_to_port(s0))
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    jb, jflat0 = JaxCodec().encode(0, s0, None)
    jd, _ = JaxCodec().encode(1, s1, jflat0)
    params, _ = _decode_port([jb], s0)
    for got, want in zip(params, jax.tree_util.tree_leaves(s0[0])):
        np.testing.assert_array_equal(got, want)
    _check(_decode_port([jb, jd], s0), s0, s1, jd)
    codec = DeltaCheckpointCodec()
    base, flat0 = codec.encode(0, _to_port(s0), None)
    delta, _ = codec.encode(1, _to_port(s1), flat0)
    assert _keys(base) == _keys(jb) and _keys(delta) == _keys(jd)
    _check(_decode_jax([base, delta], s0), s0, s1, delta)


def _plain_state(arch: str, moments: str):
    params, opt = _model_state(arch)
    if moments == "zero":   # a version 0: the moments and the step all zero
        opt = jax.tree_util.tree_map(np.zeros_like, opt)
    return params, opt


def _bits(leaves):
    return [(np.asarray(x).dtype, np.asarray(x).shape, np.asarray(x).tobytes()) for x in leaves]


@pytest.mark.parametrize("moments", ["zero", "trained"])
@pytest.mark.parametrize("arch", ["gemma3_4b", "mamba2_370m"])
def test_plain_version_blobs_interchange(tmp_path, arch, moments):
    """The plain path (no codec): a version blob the port writes restores
    through the reference's ``TrainerStateObject.Restore``, and one the
    reference writes (``np.savez_compressed``) through the port's, bit for
    bit, with the step and the loss history."""
    from repro.checkpoint.trainer_so import TrainerStateObject as JaxTrainer
    from repro_torch.checkpoint import TrainerStateObject

    state = _plain_state(arch, moments)
    blank = jax.tree_util.tree_map(lambda x: np.full_like(x, 7), state)
    want = _bits(jax.tree_util.tree_leaves(state))

    port = TrainerStateObject(tmp_path / "port_w", lambda: _to_port(state), None, device="cpu")
    port.step, port.loss_history = 5, [(4, 1.25)]
    ref = JaxTrainer(tmp_path / "ref_r", lambda: blank, None)
    ref.store.write(0, port._snapshot_blob(0), b"meta")
    assert ref.Restore(0) == b"meta"
    assert _bits(jax.tree_util.tree_leaves((ref.params, ref.opt_state))) == want
    assert ref.step == 5 and ref.loss_history == [(4, 1.25)]

    ref = JaxTrainer(tmp_path / "ref_w", lambda: state, None)
    ref.step, ref.loss_history = 6, [(5, 0.5)]
    port = TrainerStateObject(tmp_path / "port_r", lambda: _to_port(blank), None, device="cpu")
    port.store.write(0, ref._snapshot_blob(0), b"meta")
    assert port._restore(0) == b"meta"
    got = [t.numpy() for t in tree_flatten((port.params, port.opt_state))[0]]
    assert _bits(got) == want
    assert port.step == 6 and port.loss_history == [(5, 0.5)]

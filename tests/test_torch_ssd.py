"""The port's SSD (plain version of the CUDA kernel) and Mamba-2 mixer
against the JAX package.

On the CPU ``ops.ssd`` runs its plain version, the sequential recurrence
``ref.ssd_ref``. It is held against the reference's Pallas kernel (interpret
mode) and its ``ref.ssd_ref`` on the same numpy inputs, at the shapes and
tolerances of ``tests/test_kernels.py``. ``models/ssm.py`` is held against
``repro/models/ssm.py`` function by function. The CUDA kernels themselves are
held against the plain version in ``tests/test_torch_cuda.py``, on a card;
here a plain emulation of their arithmetic (``_emulate_kernels``: the f32
path, and the bf16 path with its three roundings) is held against the JAX
kernel and a float64 recurrence.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

JCFG = jax_get_config("mamba2_370m", smoke=True)
CFG = get_config("mamba2-370m", smoke=True)


def _ssd_inputs(b, s, h, p, n, g, seed=2):
    """The recipe of tests/test_kernels.py:72-81, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _pair(a: np.ndarray, bf16: bool):
    """The same values as a jax array and a torch tensor (bf16: both round
    the f32 input to nearest even)."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("s,h,p,n,g,chunk", [
    (64, 2, 16, 16, 1, 16),
    (128, 4, 32, 32, 2, 32),
    (64, 2, 64, 128, 1, 32),
])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_ssd_matches_jax_kernel_and_oracle(s, h, p, n, g, chunk, bf16):
    x, dt, A, Bm, Cm = _ssd_inputs(2, s, h, p, n, g)
    (xj, xt), (dtj, dtt), (bj, bt), (cj, ct) = (_pair(a, bf16) for a in (x, dt, Bm, Cm))
    got = ops.ssd(xt, dtt, torch.from_numpy(A), bt, ct, chunk=chunk)
    assert got.dtype == xt.dtype and got.shape == (2, s, h, p)
    got = got.float().numpy()
    # the bounds of tests/test_kernels.py:82
    tol = 5e-2 if bf16 else 1e-4
    for want in (jops.ssd(xj, dtj, jnp.asarray(A), bj, cj, chunk=chunk, interpret=True),
                 jref.ssd_ref(xj, dtj, jnp.asarray(A), bj, cj)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_model_chunked_ssd_matches_oracle():
    """Twin of tests/test_kernels.py::test_model_chunked_ssd_matches_oracle:
    the port's chunked path equals its sequential recurrence."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(2, 64, 4, 16, 16, 1, seed=3))
    y, state = tssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    assert state.shape == (2, 4, 16, 16) and state.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref.ssd_ref(x, dt, A, Bm, Cm).numpy(),
                               atol=1e-4, rtol=1e-4)


def test_ssd_chunked_final_state_and_initial_state_match_jax():
    x, dt, A, Bm, Cm = _ssd_inputs(2, 32, 4, 16, 16, 2, seed=5)
    init = np.random.default_rng(6).standard_normal((2, 4, 16, 16)).astype(np.float32)
    yj, sj = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=8,
                              initial_state=jnp.asarray(init))
    yt, st = tssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=8,
                              initial_state=torch.from_numpy(init))
    # f32 sums in another order (einsum contraction order, loop vs lax.scan)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def mixer_params():
    """One layer's mixer weights from the JAX initialiser, with the
    parameters it initialises to constants (A_log, dt_bias, conv_b, norm_w,
    D) drawn at random so that every term of the mixer is exercised."""
    descs = jssm.ssm_descs(JCFG)
    p = jax_init_params(descs, jax.random.key(0), dtype=jnp.float32)
    p = jax.tree_util.tree_map(np.asarray, p)
    rng = np.random.default_rng(1)
    for k in ("A_log", "dt_bias", "conv_b", "norm_w", "D"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
    return p


def _both(p):
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_jax(p, device="cpu")


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_mamba2_mixer_matches_jax(mixer_params, impl):
    """ssd_impl None (the model's chunked path) and ops.ssd_model_impl (the
    kernel's entry point: Pallas interpret on the JAX side, the plain
    version here). Two chunks of the smoke config's chunk 8."""
    pj, pt = _both(mixer_params)
    x = np.random.default_rng(7).standard_normal((2, 16, CFG.d_model)).astype(np.float32)
    yj, cj = jssm.mamba2_mixer(pj, jnp.asarray(x), JCFG,
                               ssd_impl=jops.ssd_model_impl if impl == "kernel" else None)
    yt, ct = tssm.mamba2_mixer(pt, torch.from_numpy(x), CFG,
                               ssd_impl=ops.ssd_model_impl if impl == "kernel" else None)
    assert cj is None and ct is None and yt.shape == (2, 16, CFG.d_model)
    # outputs of magnitude ~4; f32 sums in another order agree to ~3e-6
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5, rtol=1e-5)


def test_mamba2_mixer_cache_branch_matches_jax(mixer_params):
    s = CFG.ssm
    di, gn, nh = s.d_inner(CFG.d_model), s.n_groups * s.d_state, s.n_heads(CFG.d_model)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, s.d_conv - 1, di + 2 * gn)).astype(np.float32)
    state = rng.standard_normal((2, nh, s.head_dim, s.d_state)).astype(np.float32)
    pj, pt = _both(mixer_params)
    yj, cj = jssm.mamba2_mixer(pj, jnp.asarray(x), JCFG,
                               cache={"conv": jnp.asarray(conv), "state": jnp.asarray(state)})
    yt, ct = tssm.mamba2_mixer(pt, torch.from_numpy(x), CFG,
                               cache={"conv": torch.from_numpy(conv),
                                      "state": torch.from_numpy(state)})
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5, rtol=1e-5)
    assert sorted(ct) == sorted(cj) == ["conv", "state"]
    # the new conv window ends in this step's projections (f32 dots)
    np.testing.assert_allclose(ct["conv"].numpy(), np.asarray(cj["conv"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ct["state"].numpy(), np.asarray(cj["state"]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_jax(g):
    b, h, p, n = 2, 4, 16, 16
    x, dt, A, Bm, Cm = _ssd_inputs(b, 1, h, p, n, g, seed=9)
    state = np.random.default_rng(10).standard_normal((b, h, p, n)).astype(np.float32)
    yj, sj = jssm.ssd_decode_step(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, state)))
    yt, st = tssm.ssd_decode_step(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, state)))
    assert yt.shape == (b, 1, h, p) and st.shape == (b, h, p, n)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6, rtol=1e-6)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    # the same K taps added in the same order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def _emulate_kernels(x, dt, A, Bm, Cm, chunk: int, *, bf16: bool) -> torch.Tensor:
    """A plain emulation of the CUDA kernels' arithmetic (csrc/ssd.cu). Per
    chunk: the decay sums cum = cumsum(dt A) of the f32 products, summed in
    float64; each exponent cum_i - cum_j rounded once to f32 before exp;
    C B^T, gate x, the chunk states and C prev^T summed in f32; the states
    passed in f32. The bf16 (tensor-core) path adds its three roundings to
    bf16: the gate (C B^T) exp(cum_i - cum_j) dt_j, x exp(cum_last - cum) dt
    in the chunk state, and the state prev as the operand of C prev^T.
    x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N) -> y in x's dtype."""
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    xf, dtf = x.float(), dt.float()
    Bh = torch.repeat_interleave(Bm.float(), rep, dim=2)
    Ch = torch.repeat_interleave(Cm.float(), rep, dim=2)
    dA = dtf * A.float()
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[None, :, :, None]
    prev = torch.zeros(b, h, p, Bm.shape[3])
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        cum = torch.cumsum(dA[:, sl].double(), dim=1)                  # (B,L,H)
        seg = (cum[:, :, None] - cum[:, None, :]).float()              # (B,i,j,H)
        decay = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
        cb = torch.einsum("bihn,bjhn->bijh", Ch[:, sl], Bh[:, sl])
        gate = rnd(cb * decay * dtf[:, None, sl])
        y = torch.einsum("bijh,bjhp->bihp", gate, xf[:, sl])
        y_inter = torch.einsum("bihn,bhpn->bihp", Ch[:, sl], rnd(prev))
        ys.append(y_inter * torch.exp(cum.float())[..., None] + y)
        w = torch.exp((cum[:, -1:] - cum).float()) * dtf[:, sl]        # (B,L,H)
        contrib = torch.einsum("bjhn,bjhp->bhpn", Bh[:, sl], rnd(xf[:, sl] * w[..., None]))
        prev = prev * torch.exp(cum[:, -1].float())[..., None, None] + contrib
    return torch.cat(ys, dim=1).to(x.dtype)


def _ssd_float64(x, dt, A, Bm, Cm) -> np.ndarray:
    """The sequential recurrence in float64 on the (already rounded) inputs."""
    x, dt, A, Bm, Cm = (np.asarray(t, np.float64) for t in (x, dt, A, Bm, Cm))
    rep = x.shape[2] // Bm.shape[2]
    Bh, Ch = np.repeat(Bm, rep, axis=2), np.repeat(Cm, rep, axis=2)
    state = np.zeros(x.shape[:1] + x.shape[2:] + Bm.shape[3:])
    ys = []
    for t in range(x.shape[1]):
        state = (state * np.exp(dt[:, t] * A)[..., None, None]
                 + np.einsum("bh,bhp,bhn->bhpn", dt[:, t], x[:, t], Bh[:, t]))
        ys.append(np.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return np.stack(ys, axis=1)


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("s,h,p,n,g,chunk", [
    (64, 2, 16, 16, 1, 16),
    (128, 4, 32, 32, 2, 32),
    (64, 2, 64, 128, 1, 32),
    (32, 8, 16, 16, 1, 8),
])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kernel_emulation_matches_jax_kernel_and_float64(s, h, p, n, g, chunk, bf16):
    """The CUDA kernels' arithmetic, f32 and bf16 with its roundings, within
    the bounds of tests/test_kernels.py:82 of the reference's Pallas kernel
    (interpret mode) on the same inputs and of a float64 recurrence."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, s, h, p, n, g, seed=12)
    (xj, xt), (dtj, dtt), (bj, bt), (cj, ct) = (_pair(a, bf16) for a in (x, dt, Bm, Cm))
    got = _emulate_kernels(xt, dtt, torch.from_numpy(A), bt, ct, chunk, bf16=bf16)
    assert got.dtype == xt.dtype and got.shape == (2, s, h, p)
    tol = 5e-2 if bf16 else 1e-4
    want = jops.ssd(xj, dtj, jnp.asarray(A), bj, cj, chunk=chunk, interpret=True)
    np.testing.assert_allclose(_as_np(got), np.asarray(want, np.float32), atol=tol, rtol=tol)
    exact = _ssd_float64(*(_as_np(t) for t in (xt, dtt)), A, *(_as_np(t) for t in (bt, ct)))
    np.testing.assert_allclose(_as_np(got), exact, atol=tol, rtol=tol)


def test_mamba2_head_geometry_strong_decay():
    """mamba2-370m's head (P 64, N 128, chunk 256) over 3 chunks, 2 groups
    of 2 heads, with dt strong enough that the decay sums reach the
    hundreds within a chunk. The plain version, the reference's ssd_ref and
    the kernels' f32 arithmetic stay within 1e-4 of a float64 recurrence;
    its bf16 arithmetic within 5e-2, as does the reference's Pallas kernel
    on bf16 inputs."""
    rng = np.random.default_rng(13)
    b, s, h, p, n, g, chunk = 1, 768, 4, 64, 128, 2, 256
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) + 1.0)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cum = np.cumsum((dt * A).reshape(b, s // chunk, chunk, h), axis=2)
    assert cum.min() < -300  # the decay sums reach the hundreds

    exact = _ssd_float64(x, dt, A, Bm, Cm)
    xt, dtt, At, bt, ct = (torch.from_numpy(a) for a in (x, dt, A, Bm, Cm))
    plain = ops.ssd(xt, dtt, At, bt, ct, chunk=chunk).numpy()
    want = np.asarray(jref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm))))
    np.testing.assert_allclose(plain, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(plain, exact, atol=1e-4, rtol=1e-4)
    emu = _emulate_kernels(xt, dtt, At, bt, ct, chunk, bf16=False).numpy()
    np.testing.assert_allclose(emu, exact, atol=1e-4, rtol=1e-4)

    (xj, xb), (dtj, dtb), (bj, bb), (cj, cb) = (_pair(a, True) for a in (x, dt, Bm, Cm))
    exact16 = _ssd_float64(*(_as_np(t) for t in (xb, dtb)), A, *(_as_np(t) for t in (bb, cb)))
    emu16 = _as_np(_emulate_kernels(xb, dtb, At, bb, cb, chunk, bf16=True))
    np.testing.assert_allclose(emu16, exact16, atol=5e-2, rtol=5e-2)
    jk16 = jops.ssd(xj, dtj, jnp.asarray(A), bj, cj, chunk=chunk, interpret=True)
    np.testing.assert_allclose(emu16, np.asarray(jk16, np.float32), atol=5e-2, rtol=5e-2)


def test_ssd_wrapper_shape_contract():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(1, 24, 2, 16, 16, 1))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.ssd(x, dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="expected"):
        ops.ssd(x, dt[:, :, :1], A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        tssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)

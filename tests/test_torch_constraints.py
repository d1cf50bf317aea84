"""The port's sharding constraints and zero gradients, on plain tensors.

  * the reference's ``constrain*`` helpers, ported as DTensor
    redistributions (``models/tuning.py``), hand a plain tensor back as it
    is, and every architecture's smoke train and prefill steps are
    bit-identical with ``constrain_activations`` and
    ``decode_seq_constraint`` on (a train or prefill step decodes nothing),
    and so is a decode step with ``constrain_activations`` on;
  * zamba2's smoke config at one layer, below the shared attention block's
    first site, trains: the block's leaves get zero gradients, as under
    ``jax.grad``, and AdamW still decays them; the step equals the JAX
    package's (loss, and the params after one step as
    tests/test_torch_arch_smoke.py holds them).

f32 on the CPU; weights from seeded generators, the JAX step's from the JAX
package (``params_from_jax``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.launch import make_prefill_step, make_serve_step, make_train_step  # noqa: E402
from repro_torch.models.tuning import (constrain, constrain_batch_sharded,  # noqa: E402
                                       constrain_replicated_heads, constrain_seq_sharded,
                                       tuning)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

B, S, LR = 2, 16, 1e-3
BOTH = {"constrain_activations": True, "decode_seq_constraint": True}


def _batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.source_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _params(cfg, seed=0):
    params = tm.init_params(tm.param_descs(cfg), torch.Generator().manual_seed(seed),
                            dtype=torch.float32, device="cpu")
    if cfg.family == "vlm":  # every gate is 0 at init: the cross blocks would be the identity
        cross = params["group_cross"]
        cross["attn"]["gate"] = torch.full_like(cross["attn"]["gate"], 0.7)
        cross["mlp_gate"] = torch.full_like(cross["mlp_gate"], -0.4)
    return params


def test_the_helpers_hand_a_plain_tensor_back():
    x = torch.randn(2, 3, 4, 5)
    assert constrain(x, ("data", None, None, None)) is x
    assert constrain_seq_sharded(x, 1) is x
    assert constrain_replicated_heads(x) is x
    with tuning(constrain_activations=True):
        assert constrain_batch_sharded(x) is x


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_steps_are_bit_identical_with_the_constraint_flags(arch):
    cfg = port_get_config(arch, smoke=True)
    params = _params(cfg)
    batch = _batch(cfg, S + 1, seed=1)
    outs = []
    for tune in ({}, BOTH):
        with tuning(**tune):
            p2, o2, loss = make_train_step(cfg, AdamWConfig(lr=LR), remat="full")(
                params, adamw_init(params), batch)
            logits = make_prefill_step(cfg)(params, {**batch, "tokens": batch["tokens"][:, :S]})
        outs.append([loss, logits] + tree_flatten(p2)[0] + tree_flatten(o2)[0])
    assert all(torch.equal(a, b) for a, b in zip(*outs))

    decoded = []
    for tune in ({}, {"constrain_activations": True}):
        cache = tm.zeros_from_descs(tm.cache_descs(cfg, batch=B, max_len=S), device="cpu")
        with tuning(**tune):
            for i in range(2):
                lg, cache = make_serve_step(cfg)(
                    params, cache, {**batch, "tokens": batch["tokens"][:, i:i + 1]}, i)
        decoded.append([lg] + tree_flatten(cache)[0])
    assert all(torch.equal(a, b) for a, b in zip(*decoded))


def test_zamba2_below_its_first_shared_site_trains_as_the_reference():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro.models import init_params as jax_init_params
    from repro.models import param_descs as jax_param_descs
    from repro.optim import AdamWConfig as JaxAdamWConfig
    from repro.optim import adamw_init as jax_adamw_init

    cfg = dataclasses.replace(get_config("zamba2_1p2b", smoke=True), num_layers=1)
    tcfg = dataclasses.replace(port_get_config("zamba2_1p2b", smoke=True), num_layers=1)
    assert tcfg.num_layers < tcfg.hybrid_attn_period  # the shared block runs nowhere
    jp = jax_init_params(jax_param_descs(cfg), jax.random.key(0), jnp.float32)
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    batch = _batch(tcfg, S + 1, seed=2)
    pj, _, lj = jax.jit(jax_make_train_step(cfg, JaxAdamWConfig(lr=LR), remat="none"))(
        jp, jax_adamw_init(jp), batch)
    pt, ot, lt = make_train_step(tcfg, AdamWConfig(lr=LR), remat="none")(
        tp, adamw_init(tp), batch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert int(ot["step"]) == 1
    # the unreached block: zero first moments, and the weight decay applied
    shared = tree_flatten(ot["m"]["shared_attn"])[0]
    assert shared and all(not bool(m.any()) for m in shared)
    wd = AdamWConfig().weight_decay
    for got, before in zip(tree_flatten(pt["shared_attn"])[0], tree_flatten(tp["shared_attn"])[0]):
        torch.testing.assert_close(got, before * (1 - LR * wd), rtol=1e-6, atol=1e-9)
    diffs = np.concatenate([np.abs(got.numpy() - np.asarray(w)).ravel()
                            for got, w in zip(tree_flatten(pt)[0], jax.tree_util.tree_leaves(pj))])
    assert diffs.max() <= 2 * LR and diffs.mean() <= 1e-6

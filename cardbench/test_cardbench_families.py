"""A configuration of any of the system's families reaches the program as
data: the ``model`` object becomes the system's ModelConfig and its step
options, the options hold while the program runs, and the reference's step
composes the loss of a family with an auxiliary loss as the program does."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from cardbench import harness, testing  # noqa: E402
from cardbench.reference import common  # noqa: E402


def as_file(cfg) -> dict:
    """A ModelConfig as a configuration file states it: JSON, the name at
    the top level."""
    model = json.loads(json.dumps(dataclasses.asdict(cfg)))
    return {"name": model.pop("name"), "model": model}


def _architectures():
    from repro_torch.configs import ARCHITECTURES

    return ARCHITECTURES


@pytest.mark.parametrize("arch", _architectures())
def test_every_config_of_the_system_round_trips(arch):
    import importlib

    cfg = importlib.import_module(f"repro_torch.configs.{arch}").config()
    assert harness.program_model(as_file(cfg)) == (cfg, {})


def test_an_unknown_model_key_raises():
    from repro_torch.configs.mamba2_370m import config

    data = as_file(config())
    data["model"]["num_layer"] = 3
    with pytest.raises(KeyError, match="num_layer"):
        harness.program_model(data)
    data["model"]["ssm"]["d_stat"] = 3
    del data["model"]["num_layer"]
    with pytest.raises(KeyError, match="ssm.'d_stat'"):
        harness.program_model(data)


def test_step_options_hold_in_the_step_and_go_after_the_run():
    """A ``Tuning`` field in ``model`` is what the step reads while a run
    drives it (set-up, window and kill alike), not the reference; the
    default is back once the run is over."""
    from repro_torch.models.tuning import Tuning, get_tuning

    cell = testing.smoke_cell("zamba2-1.2b-x8.train-kill")
    cell.config["model"]["loss_chunk"] = 8
    seen = []

    def spy(step_fn):
        def step(params, opt_state, batch):
            seen.append(get_tuning())
            return step_fn(params, opt_state, batch)
        return step

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = harness.run_cell(cell, 4_000_000_321, 1.0, False, device="cpu", wrap_step=spy)
    finally:
        torch.set_num_threads(threads)
    assert len(seen) > cell.traffic["warmup_steps"]
    assert set(seen) == {Tuning(loss_chunk=8)}
    assert get_tuning() == Tuning()
    assert out["correct"] is True, out["checks"]


def test_the_reference_step_composes_the_programs_loss_with_aux():
    """On the system's deepseek smoke configuration (MLA, routed and shared
    experts, a dense first layer), the reference's step, given a forward
    that returns (logits, aux), follows the program's train step from the
    same weights over the same batches: the same 3 losses and parameters,
    within 1e-6 relative (bit-equal on the CPU with torch 2.x, where this
    was written: the reference's step is a frozen copy of the program's)."""
    from repro_torch.configs.deepseek_v2_lite_16b import smoke_config
    from repro_torch.models import forward, init_params, param_descs
    from repro_torch.models.tuning import tuning
    from repro_torch.optim import adamw_init

    data = as_file(smoke_config())
    data["model"]["moe_impl"] = "einsum"
    cfg, options = harness.program_model(data)
    traffic = json.loads((harness.HERE / "traffic" / "train-steady.json").read_text())
    traffic = dict(traffic, remat="none")
    opt = dict(traffic["optimizer"])
    params = init_params(param_descs(cfg), torch.Generator().manual_seed(7), device="cpu")
    paths, p0 = zip(*common.flatten(params))
    gen = torch.Generator().manual_seed(8)
    batches = [torch.randint(0, cfg.vocab_size, (2, 17), generator=gen) for _ in range(3)]

    def with_aux(m, tree, tokens):
        logits, _, aux = forward(cfg, tree, tokens, remat="none")
        return logits, aux

    step = harness.program_step(cfg, traffic)
    prog_p, prog_s, prog_loss = params, adamw_init(params), []
    ref_p, ref_s, ref_loss = list(p0), common.adamw_init(list(p0)), []
    with harness.deterministic():
        with tuning(**options):
            for tok in batches:
                prog_p, prog_s, loss = step(prog_p, prog_s, {"tokens": tok})
                prog_loss.append(float(loss))
        for tok in batches:
            ref_p, ref_s, loss = common.train_step(with_aux, data["model"], list(paths), ref_p,
                                                   ref_s, tok, opt)
            ref_loss.append(float(loss))
    assert prog_loss == pytest.approx(ref_loss, rel=1e-6, abs=0)
    for (path, got), want in zip(common.flatten(prog_p), ref_p):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0, msg=path)
    # the aux term is in the sum: without it the first loss is not the program's
    _, _, ce = common.train_step(lambda m, tree, tokens: with_aux(m, tree, tokens)[0],
                                 data["model"], list(paths), list(p0),
                                 common.adamw_init(list(p0)), batches[0], opt)
    assert float(ce) < prog_loss[0]

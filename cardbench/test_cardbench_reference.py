"""The reference against the system's train step at smoke size on the CPU:
the same weights and batches give the same losses, first gradients and
parameter changes, within every limit of the cell."""
import json

import pytest

torch = pytest.importorskip("torch")

from cardbench import calibrate, check, harness, testing  # noqa: E402

#: every cell of the benchmark, so that a cell a later change adds is held too
CELLS = [w["name"] for w in
         json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_program(cell):
    c = testing.smoke_cell(cell)
    with harness.deterministic():
        prog = calibrate.program_readings(c, 11, torch.device("cpu"))
        ref = calibrate.reference(c, 11, torch.device("cpu"))
    assert len(prog["loss"]) == len(ref["loss"]) == c.traffic["warmup_steps"]
    assert prog["grad"].keys() == ref["grad"].keys() == prog["update"].keys()
    numbers = {k: v for k, (v, _) in check.compare(prog, ref).items()}
    for name, value in numbers.items():
        assert value <= c.config["limits"][name], (name, value)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_forward_is_the_programs(cell):
    from repro_torch.models import forward, tuning

    c = testing.smoke_cell(cell)
    m = c.config["model"]
    fam = harness.family(c.config)
    params = __import__("cardbench.weights", fromlist=["x"]).tree(fam.descs(m), 5, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, c.traffic["seq_len"]))
    with torch.no_grad():
        want = fam.forward(m, params, tokens)
        cfg, options = harness.program_model(c.config)
        with tuning(**options):
            got = forward(cfg, params, tokens)[0]
    if isinstance(want, tuple):  # (logits, aux): the logits are compared
        want = want[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

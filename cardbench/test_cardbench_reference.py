"""The reference against the system's train step at smoke size on the CPU:
the same weights and batches give the same losses, first gradients and
parameter changes, within every limit of the cell."""
import pytest

torch = pytest.importorskip("torch")

from cardbench import calibrate, check, harness, testing  # noqa: E402

CELLS = ["mamba2-370m.train-steady", "zamba2-1.2b-x8.train-kill"]


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
    from repro_torch.models import forward

    c = testing.smoke_cell(cell)
    m = c.config["model"]
    fam = harness.family(c.config)
    params = __import__("cardbench.weights", fromlist=["x"]).tree(fam.descs(m), 5, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, c.traffic["seq_len"]))
    with torch.no_grad():
        want = fam.forward(m, params, tokens)
        got = forward(harness.program_config(c.config), params, tokens)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

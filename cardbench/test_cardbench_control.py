"""The control on the card, at a cell's own sizes: the reference in TF32,
the precision below the configured float32, put in the program's place,
fails a number of the cell; the program itself passes them all. Three
seeds a cell, each with the planted faults too; about five minutes for
the mamba2 cell (16 x 2048 tokens a step), one for the zamba2 cell."""
import pytest

torch = pytest.importorskip("torch")

from cardbench import calibrate, harness  # noqa: E402

CELLS = ["mamba2-370m.train-steady", "zamba2-1.2b-x8.train-kill"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32, which only the card has")
    c = harness.load_cell(cell)
    limits = c.config["limits"]
    out = calibrate.calibrate(c, [5_000_000_011 + 7919 * i for i in range(3)], 3,
                              torch.device("cuda"), log=lambda line: None)
    for row in out["sound"]:
        assert all(row[k] <= limits[k] for k in limits), row
    for row in out["control"]:
        assert any(row[k] > limits[k] for k in limits), row

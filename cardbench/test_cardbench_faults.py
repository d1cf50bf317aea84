"""A run with the timed path broken underneath comes out not correct, for
each fault a one-chip training cell can have: a step that returns its state
unchanged, half of the batch left out, a token altered where it is
produced. The harness's look for a chip is skipped (smoke size, CPU); the
rest of the run is the run's own."""
import pytest

torch = pytest.importorskip("torch")

from cardbench import testing  # noqa: E402

CELLS = ["mamba2-370m.train-steady", "zamba2-1.2b-x8.train-kill"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_token"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    out = testing.run_smoke_process(cell, fault)
    assert out["correct"] is False
    failed = [n for n, c in out["checks"].items() if not c["value"] <= c["limit"]]
    assert set(failed) & {"loss_rel_gap", "grad_norm_gap", "update_norm_gap"}, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = testing.run_smoke_process(cell)
    assert out["correct"] is True, out["checks"]

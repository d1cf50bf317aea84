"""The FLOP formulas against shape arithmetic at smoke size: the products
torch's FLOP counter sees in the reference's forward, plus the depthwise
conv the formulas count and the counter (which sees only products) does
not."""
import json

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from cardbench import harness, testing, weights  # noqa: E402
from cardbench.flops import blocks  # noqa: E402

#: every cell of the benchmark, so that a cell a later change adds is held too
CELLS = [w["name"] for w in
         json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def conv_flops(m, seq):
    """The depthwise conv of a model's Mamba-2 blocks; 0 without them."""
    s = m.get("ssm")
    if not s:
        return 0
    di = s["expand"] * m["d_model"]
    return 2 * seq * s["d_conv"] * (di + 2 * s["n_groups"] * s["d_state"])


@pytest.mark.parametrize("cell", CELLS)
def test_forward_flops_match_the_products(cell):
    c = testing.smoke_cell(cell)
    m = c.config["model"]
    fam = harness.family(c.config)
    params = weights.tree(fam.descs(m), 1, "cpu")
    B, S = 2, c.traffic["seq_len"]
    tokens = torch.randint(0, m["vocab_size"], (B, S))
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fam.forward(m, params, tokens)
    flops = __import__(f"cardbench.flops.{m['family']}", fromlist=["x"])
    want = flops.train_flops(m, B, S) // 3 - B * m["num_layers"] * conv_flops(m, S)
    assert counter.get_total_flops() == want


def test_train_flops_at_the_cells_sizes():
    """Per token, mamba2-370m (tied head) about 6 x its parameters, the
    head's product with the embedding table included, plus the SSD's
    products and the conv (about 14% more); the head alone is
    2 x d_model x padded vocab a token."""
    c = harness.load_cell("mamba2-370m.train-steady")
    m = c.config["model"]
    assert m["tie_embeddings"]
    flops = __import__("cardbench.flops.ssm", fromlist=["x"])
    per_token = flops.train_flops(m, 1, 2048) / 2048
    params = c.config["parameters"]
    assert 6 * params < per_token < 6 * params * 1.2
    assert blocks.head(m, 1) == 2 * 1024 * 51200

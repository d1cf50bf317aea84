"""Every cell's files parse, every metric is found by name, and the
configurations are the system's own at the sizes they state."""
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from cardbench import harness  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_parse(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] in cell and c.traffic["name"] in cell
    assert c.traffic["kind"] == "train"
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "train_tokens_per_s"}
    assert c.per_layer
    harness.family(c.config).descs(c.config["model"])


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end", "per_layer")
                                    for m in BENCH[k]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_reader(metric))


#: keys that are widths, which ``reduced`` may never name
WIDTHS = re.compile(r"^(d_model|d_ff|d_state|expand|head_dim|hidden_size|intermediate_size)$"
                    r"|_dim$|_rank$|_size$")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_published_one_but_for_reduced(config):
    """Every published number the file states is run as published, but for
    the keys it lists under ``reduced`` (cuts of depth, never a width) and
    those it lists under ``not_implemented`` (what the system cannot run as
    published, which the model object does not name); its parameter count
    is stated."""
    from repro_torch.models import param_count, param_descs

    data = json.loads((ROOT / config["file"]).read_text())
    assert data["reduced"] == config["reduced"] and data["source"] == config["source"]
    pub, model, skip = data["published"], data["model"], data["not_implemented"]
    assert not [k for k in data["reduced"] if WIDTHS.search(k)]
    assert set(data["reduced"]) <= set(pub) and not set(skip) & set(data["reduced"])
    for key, want in pub.items():
        if key == "from":
            continue
        if key in skip:
            assert key not in model, key
        elif key == "ssm":
            assert {k: model["ssm"][k] for k in want} == want
        elif key in data["reduced"]:
            assert model[key] != want, key
            if key == "num_layers":
                assert model[key] < want
        else:
            assert model[key] == want, key
    cfg = harness.program_config(data)
    assert param_count(param_descs(cfg)) == data["parameters"]
    harness.check_layout(cfg, harness.family(data).descs(data["model"]))

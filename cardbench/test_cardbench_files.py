"""Every cell's files parse, every metric is found by name, and the
configurations are the system's own at the sizes they state."""
import dataclasses
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


#: the cuts ``reduced`` may make in ``model`` (the ``model-configs`` guide's
#: section 4): depth below the published one, the chip's slice of the
#: vocabulary down to an eighth of it. No other key of ``model`` is cut: no
#: width, and not the router's count of experts or experts a token takes
CUTS = {"num_layers": lambda have, want: have < want,
        "vocab_size": lambda have, want: 8 * have >= want and have < want}
#: the counts a chip may hold a share of while ``model`` keeps the published
#: one (the router stays 64 wide over a chip's 8 experts): the file's
#: ``share`` maps the path to the step option that gives the share here
SHARES = {"num_experts": lambda held, want: 8 <= held < want and want % held == 0}
#: a catalog model's keys, which the file states at its top level as run, and
#: the path of ``published`` and ``model`` each one is
CATALOG = {"hidden_size": "d_model", "num_hidden_layers": "num_layers",
           "n_routed_experts": "moe.num_experts", "moe_intermediate_size": "moe.d_expert",
           "num_experts_per_tok": "moe.top_k", "vocab_size": "vocab_size"}
MISSING = object()


def at(tree: dict, path: str):
    for key in path.split("."):
        if not isinstance(tree, dict) or key not in tree:
            return MISSING
        tree = tree[key]
    return tree


def check_published(data: dict) -> None:
    """Every published number the file states is what the program runs, but
    for the paths it lists under ``reduced`` and those it lists under
    ``not_implemented`` (what the system cannot run as published, which the
    model object does not name). A ``reduced`` entry is a dotted path into
    ``published`` (``moe.num_experts``), or a catalog key (``CATALOG``) for
    one: a cut of ``model`` (``CUTS``), or a chip's share (``SHARES``) that a
    step option gives while ``model`` keeps the published count. A catalog
    key at the file's top level is what the program runs at its path. Raises
    AssertionError."""
    _, options = harness.program_model(data)
    pub, model, skip = data["published"], data["model"], data["not_implemented"]
    share = data.get("share", {})

    def run(path):
        """What the program runs at a path: the share's option, or ``model``."""
        return options.get(share[path], MISSING) if path in share else at(model, path)

    cut = [CATALOG.get(k, k) for k in data["reduced"]]
    assert set(share) <= set(cut), "a share that reduced does not list"
    for path in cut:
        leaf, want, have = path.split(".")[-1], at(pub, path), run(path)
        assert path.split(".")[0] not in skip, f"{path}: not implemented"
        assert want is not MISSING and not isinstance(want, dict), f"{path}: not published"
        assert have is not MISSING, f"{path}: not run"
        if path in share:
            assert leaf in SHARES, f"{path}: no share of it may be held"
            assert at(model, path) == want, f"{path}: the model's count is cut"
            assert SHARES[leaf](have, want), f"{path}: a share past the floor"
        else:
            assert leaf in CUTS, f"{path}: not a cut of depth or vocabulary"
            assert CUTS[leaf](have, want), f"{path}: a cut past the floor"
    for key, want in pub.items():
        if key == "from":
            continue
        if key in skip:
            assert key not in model, key
            continue
        leaves = ([(f"{key}.{k}", v) for k, v in want.items()] if isinstance(want, dict)
                  else [(key, want)])
        for path, value in leaves:
            if path not in cut:
                assert at(model, path) == value, path
    for key, path in CATALOG.items():
        if key in data:
            assert data[key] == run(path), f"{key}: not what the program runs at {path}"


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_published_one_but_for_reduced(config):
    """The file is run as published but for its cuts (``check_published``);
    its parameter count is stated, and the program's parameter tree is the
    reference's."""
    from repro_torch.models import param_count, param_descs

    data = json.loads((ROOT / config["file"]).read_text())
    assert data["reduced"] == config["reduced"] and data["source"] == config["source"]
    check_published(data)
    cfg, _ = harness.program_model(data)
    assert param_count(param_descs(cfg)) == data["parameters"]
    harness.check_layout(cfg, harness.family(data).descs(data["model"]))


@pytest.fixture
def experts_held(monkeypatch):
    """A step option that gives the routed experts a chip holds, as the
    port's ``Tuning`` will have it for DeepSeek-V2-Lite's one-chip share."""
    import importlib

    module = importlib.import_module("repro_torch.models.tuning")

    @dataclasses.dataclass(frozen=True)
    class Tuning(module.Tuning):
        experts_held: int = 0

    monkeypatch.setattr(module, "Tuning", Tuning)


def moe_file(share=None, **cuts) -> dict:
    """A configuration file of the ``moe`` family as DeepSeek-V2-Lite's
    one-chip share would state it: the published numbers, the run's model
    with a step option, ``cuts`` (dotted path -> run value in ``model``) and
    ``share`` (dotted path -> experts held, given by ``experts_held``), both
    listed under ``reduced``."""
    pub = {"from": "DeepSeek-V2-Lite's config.json", "num_layers": 27, "d_model": 2048,
           "num_heads": 16, "num_kv_heads": 16, "d_ff": 1408, "vocab_size": 102400,
           "norm_eps": 1e-06, "tie_embeddings": False,
           "moe": {"num_experts": 64, "top_k": 6, "d_expert": 1408, "num_shared": 2,
                   "first_k_dense": 1, "dense_d_ff": 10944},
           "mla": {"kv_lora_rank": 512, "q_lora_rank": 0, "qk_nope_head_dim": 128,
                   "qk_rope_head_dim": 64, "v_head_dim": 128}}
    model = dict(json.loads(json.dumps({k: v for k, v in pub.items() if k != "from"})),
                 family="moe", moe_impl="einsum")
    for path, value in cuts.items():
        *head, last = path.split(".")
        node = model
        for key in head:
            node = node[key]
        node[last] = value
    data = {"name": "deepseek-v2-lite-x8", "published": pub, "model": model,
            "not_implemented": {}, "reduced": list(cuts)}
    if share:
        [(path, held)] = share.items()
        data["reduced"].append(path)
        data["share"] = {path: "experts_held"}
        model["experts_held"] = held
    return data


def test_a_moe_file_with_the_guides_cuts_and_a_step_option_is_accepted(experts_held):
    data = moe_file(share={"moe.num_experts": 8}, vocab_size=12800)
    check_published(data)
    cfg, options = harness.program_model(data)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.vocab_size) == (64, 6, 12800)
    assert cfg.mla.kv_lora_rank == 512 and cfg.num_layers == 27
    assert options == {"moe_impl": "einsum", "experts_held": 8}


@pytest.mark.parametrize("share, cuts", [
    (None, {"vocab_size": 12799}), ({"moe.num_experts": 4}, {}),
    ({"moe.num_experts": 12}, {}), (None, {"moe.num_experts": 8}),
    (None, {"moe.top_k": 2}), (None, {"d_model": 1024}), (None, {"moe.d_expert": 704}),
    (None, {"mla.kv_lora_rank": 256}), (None, {"num_layers": 28}),
    ({"moe.top_k": 2}, {}), ({"vocab_size": 12800}, {})],
    ids=["vocab-under-an-eighth", "4-experts-held", "12-experts-held", "router-cut-to-8",
         "top_k", "d_model", "d_expert", "kv_lora_rank", "deeper", "top_k-held",
         "vocab-held"])
def test_a_moe_file_past_the_guides_floors_is_refused(experts_held, share, cuts):
    with pytest.raises(AssertionError):
        check_published(moe_file(share, **cuts))


def test_an_unlisted_change_is_refused(experts_held):
    data = moe_file(share={"moe.num_experts": 8})
    data["model"]["moe"]["num_shared"] = 1
    with pytest.raises(AssertionError, match="moe.num_shared"):
        check_published(data)


def test_a_share_without_its_step_option_is_refused():
    """Until the port's ``Tuning`` gives the experts a chip holds, a file
    that names such an option does not load."""
    with pytest.raises(KeyError, match="experts_held"):
        check_published(moe_file(share={"moe.num_experts": 8}))


def catalog_file(**top) -> dict:
    """The same share with a catalog model's numbers at the file's top
    level, as the catalog names them, and ``reduced`` in those names."""
    data = moe_file(share={"moe.num_experts": 8}, vocab_size=12800)
    data.update(hidden_size=2048, num_hidden_layers=27, moe_intermediate_size=1408,
                n_routed_experts=8, num_experts_per_tok=6, vocab_size=12800,
                reduced=["n_routed_experts", "vocab_size"])
    data.update(top)
    return data


def test_a_catalog_model_file_with_the_guides_cuts_is_accepted(experts_held):
    check_published(catalog_file())


@pytest.mark.parametrize("top", [{"n_routed_experts": 64}, {"vocab_size": 102400},
                                 {"hidden_size": 1024}, {"num_experts_per_tok": 2}])
def test_a_catalog_number_the_program_does_not_run_is_refused(experts_held, top):
    with pytest.raises(AssertionError):
        check_published(catalog_file(**top))


def test_a_model_cut_under_published_top_level_numbers_is_refused(experts_held):
    """The top level states the published width, ``model`` runs another:
    the file test reads ``model``, not the copy."""
    data = catalog_file()
    data["model"]["d_model"] = 1024
    with pytest.raises(AssertionError, match="d_model"):
        check_published(data)

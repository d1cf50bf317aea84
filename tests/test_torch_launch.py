"""The port's training launcher (``python -m repro_torch.launch.train``)
against the reference's, and the resilient loop on the ssm family.

The launcher runs the resilient loop on a smoke config and prints JSON with
the reference's keys. Held against the reference's launcher, both start
from the JAX-initialised weights (``params_from_jax``); the losses then
follow within the 5e-3 that the loop's amplified rounding allows
(tests/test_torch_training.py). Everything runs on the CPU.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_checkpoint  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro_torch import checkpoint as port_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.train import loop as port_loop  # noqa: E402
from repro_torch.train import run_resilient_training  # noqa: E402

KEYS = ["arch", "final_step", "params_digest", "rollbacks", "checkpoint_bytes", "first_loss",
        "last_loss"]


def _jax_weights(monkeypatch, arch):
    init = jax.tree_util.tree_map(np.asarray, jax_init_params(
        jax_param_descs(jax_get_config(arch, smoke=True)), jax.random.key(0), jnp.float32))
    monkeypatch.setattr(
        port_loop, "init_params",
        lambda descs, gen, dtype, device: params_from_jax(init, device=device, dtype=dtype))


def _port_cli(args, out, capsys):
    port_train.main(args + ["--out", str(out), "--device", "cpu"])
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("arch", ["gemma3-4b", "mamba2-370m", "zamba2-1.2b",
                                  "granite-moe-3b-a800m", "deepseek-v2-lite-16b"])
def test_cli_matches_reference_cli(arch, tmp_path, monkeypatch, capsys):
    """Failure-free runs from the same weights print the same keys and
    losses within 5e-3. (After a kill the first and last exported losses are
    of whichever steps the barrier released first and last, so losses are
    compared on failure-free runs; test_mamba2_trains_through_failures runs
    the launcher with a kill.)"""
    args = ["--arch", arch, "--steps", "6"]
    monkeypatch.setattr(sys, "argv", ["train"] + args + ["--out", str(tmp_path / "jax")])
    jax_train.main()
    want = json.loads(capsys.readouterr().out)
    _jax_weights(monkeypatch, arch)
    got = _port_cli(args, tmp_path / "port", capsys)
    assert list(got) == list(want) == KEYS
    assert got["arch"] == want["arch"] and got["final_step"] == want["final_step"] == 6
    assert got["rollbacks"] == want["rollbacks"] == 0 and got["checkpoint_bytes"] > 0
    np.testing.assert_allclose([got["first_loss"], got["last_loss"]],
                               [want["first_loss"], want["last_loss"]], rtol=5e-3)


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        port_train.main(["--arch", "mamba2-370m", "--steps", "1", "--out", str(tmp_path)])


def test_mamba2_trains_through_failures(tmp_path, capsys):
    """The ssm family through the resilient loop: a trainer kill (through
    the launcher) and a data kill each end with the failure-free run's
    params digest, and external metrics list every step once."""
    cfg = get_config("mamba2_370m", smoke=True)
    base = run_resilient_training(tmp_path / "base", cfg, steps=6, device="cpu")
    data = run_resilient_training(tmp_path / "kd", cfg, steps=6, kill_data_at=2, device="cpu")
    killed = _port_cli(["--arch", "mamba2-370m", "--steps", "6", "--kill-at", "3"],
                       tmp_path / "kt", capsys)
    assert killed["rollbacks"] >= 1 and killed["final_step"] == 6
    assert killed["params_digest"] == data.params_digest == base.params_digest
    assert sorted(s for s, _ in data.external_metrics) == list(range(6))
    assert all(np.isfinite(loss) for _, loss in base.external_metrics)


@pytest.mark.parametrize("arch,extra", [("seamless-m4t-large-v2", "frames"),
                                        ("llama-3.2-vision-90b", "image_embeds")])
def test_cli_cannot_train_the_families_with_extras(arch, extra, tmp_path, monkeypatch, capsys):
    """The loop feeds no frames or image embeddings, so both launchers fail
    in the first train step with the same KeyError. Both trainers leave the
    step's action open on that error and the cluster's shutdown then waits
    for it without end; the test lets the action end so that the error
    comes out."""
    for cls in (jax_checkpoint.TrainerStateObject, port_checkpoint.TrainerStateObject):
        train_on = cls.train_on

        def closing(self, *a, _train_on=train_on, **kw):
            try:
                return _train_on(self, *a, **kw)
            except Exception:
                self.EndAction()
                raise

        monkeypatch.setattr(cls, "train_on", closing)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--steps", "2",
                                      "--out", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match=extra):
        jax_train.main()
    with pytest.raises(KeyError, match=extra):
        port_train.main(["--arch", arch, "--steps", "2", "--out", str(tmp_path / "port"),
                         "--device", "cpu"])
    assert capsys.readouterr().out == ""

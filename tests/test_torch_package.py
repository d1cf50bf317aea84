"""Structure of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its verbatim copies of the JAX package's pure-Python modules
have not drifted from their originals."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

#: modules the port copies unchanged apart from the package name in imports
COPIED = sorted(
    [p.relative_to(REF).as_posix() for d in ("core", "durable", "store") for p in (REF / d).glob("*.py")]
    + ["data/__init__.py", "data/pipeline.py", "models/config.py", "configs/gemma_2b.py",
       "configs/mamba2_370m.py", "configs/yi_6b.py", "configs/glm4_9b.py", "configs/gemma3_4b.py",
       "configs/zamba2_1p2b.py", "configs/granite_moe_3b_a800m.py",
       "configs/deepseek_v2_lite_16b.py", "configs/seamless_m4t_large_v2.py",
       "configs/llama_3p2_vision_90b.py"]
)


#: modules the port copies with one stated difference, the fits-in-HBM key of
#: an H100's 80 GB for the TPU v5e's 16 GiB (and its own module path in the
#: usage line): the substitutions that turn the original into the copy
ADAPTED = {"analysis/report.py": [("fits_16g", "fits_hbm"), ("| fits |", "| fits 80 GB |"),
                                  ("-m repro.analysis.", "-m repro_torch.analysis.")]}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_reference(path):
    bad = {m for m in _imported_roots(path) if m in ("repro", "jax", "jaxlib") or m.startswith("jax")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_copied_module_list_is_complete():
    assert len(COPIED) == 28
    assert all((PORT / rel).exists() for rel in COPIED)


def _normalised(text: str) -> str:
    lines = []
    for line in text.splitlines():
        if line.lstrip().startswith(("from ", "import ")):
            line = line.replace("repro_torch", "repro")
        lines.append(line)
    return "\n".join(lines)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_has_not_drifted(rel):
    """Drift guard: a change to the protocol in repro/ must be carried to the
    port's copy (and vice versa), or this fails."""
    assert _normalised((PORT / rel).read_text()) == _normalised((REF / rel).read_text())


@pytest.mark.parametrize("rel", sorted(ADAPTED))
def test_adapted_copy_differs_only_as_stated(rel):
    want = (REF / rel).read_text()
    for old, new in ADAPTED[rel]:
        assert old in want, old
        want = want.replace(old, new)
    assert _normalised((PORT / rel).read_text()) == _normalised(want)


def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path):
    """``device=None`` means CUDA; without a card the entry points raise
    rather than fall back to the CPU."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    from repro_torch.checkpoint import TrainerStateObject
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.train import (DecodeSessionStateObject, run_resilient_training,
                                   run_speculative_serving)

    assert resolve_device("cpu") == torch.device("cpu")
    cfg = get_config("gemma_2b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run_resilient_training(tmp_path, cfg, steps=1)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        TrainerStateObject(tmp_path, lambda: ({}, {}), lambda *a: None)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run_speculative_serving(tmp_path, cfg, {}, n_tokens=1)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        DecodeSessionStateObject(tmp_path, cfg, {})
    assert not (tmp_path / "coordinator.jsonl").exists()


def test_new_kernel_entry_points_raise_off_cuda_and_cpu():
    """The SSD and flash-attention wrappers launch their kernel for CUDA
    tensors and take the plain version only when every input lies on the
    CPU; any other device raises rather than falling back."""
    torch = pytest.importorskip("torch")
    from repro_torch.kernels import ops

    meta = {"device": "meta"}
    x, dt, A = torch.zeros(1, 16, 2, 16, **meta), torch.zeros(1, 16, 2, **meta), torch.zeros(2, **meta)
    bc = torch.zeros(1, 16, 1, 16, **meta)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="ssd has no kernel for device meta"):
        ops.ssd(x, dt, A, bc, bc, chunk=8)
    with pytest.raises(ValueError, match="ssd has no kernel for device meta"):
        ops.ssd_model_impl(x, dt, A, bc, bc, chunk=8)
    with pytest.raises(ValueError, match="A is on cpu, expected meta"):
        ops.ssd(x, dt, torch.zeros(2), bc, bc, chunk=8)
    q = torch.zeros(1, 64, 2, 32, **meta)
    kv = torch.zeros(1, 64, 1, 32, **meta)
    with pytest.raises(ValueError, match="flash_attention has no kernel for device meta"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="k is on cpu, expected meta"):
        ops.flash_attention(q, torch.zeros(kv.shape), kv)
    assert ops.LAUNCHES == before
    # tensors on the CPU take the plain versions and launch nothing
    ops.ssd(*(torch.zeros(t.shape) for t in (x, dt, A, bc, bc)), chunk=8)
    ops.flash_attention(*(torch.zeros(t.shape) for t in (q, kv, kv)))
    assert ops.LAUNCHES == before

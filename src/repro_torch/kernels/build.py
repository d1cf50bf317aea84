"""Build layer of the hand-written CUDA kernels: one shared library per source.

Each ``csrc/*.cu`` file has a plain C interface. At first use on a CUDA
tensor, ``nvcc`` compiles it for ``sm_90a`` into
``build/kernels/lib<stem>_<hash>.so`` at the repository root (listed in
``.gitignore``), named by the hash of the source and the flags so that a
stale library is never reused, and ``ctypes`` loads it. ``ptxas`` reports
each kernel's registers, shared memory and spills into a ``.log`` beside the
library. Nothing is built on import, and a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

#: C signature of an exported function: (argtypes, restype)
Signature = Tuple[Sequence[type], type]

#: kernel launches by name since the last ``reset_launch_counts``; a wrapper
#: adds one where it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {"delta_encode": 0, "delta_decode": 0, "ssd": 0, "flash_attention": 0}

_libs: Dict[Path, ctypes.CDLL] = {}
_mu = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels need it")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(source: Path) -> Tuple[Path, float]:
    """Compile ``source`` unless its library already exists.
    Returns (library path, seconds spent compiling; 0.0 when reused)."""
    out = library_path(source)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def build_all(sources: Iterable[Path]) -> List[Tuple[Path, float]]:
    """Build several sources at once: one ``nvcc`` per source, all started
    together. Raises the first failure after every build has ended."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = [pool.submit(build, s) for s in sources]
        return [f.result() for f in futures]


def load(source: Path, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """The loaded library of ``source`` (built at first use), with the
    argument and return types of ``signatures`` set on its functions."""
    with _mu:
        lib = _libs.get(source)
        if lib is None:
            path, _ = build(source)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _libs[source] = lib
        return lib


def raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed with cudaError {err}")

"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source is compiled on its own, for ``sm_90a``, into a
shared library with a plain C interface; the sources include no PyTorch
header, so a build takes seconds. Libraries land in
``build/repro_torch_kernels/`` under the checkout (or in
``$REPRO_TORCH_BUILD_DIR``), named by a hash of their sources and flags,
so a changed source is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "sample_negatives": "sample_negatives.cu",
    "sgns_fused_step": "sgns_fused_step.cu",
}
HEADERS = ("counter_prng.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch_kernels`` at
    the root of the checkout this package sits in (the working
    directory when the package is installed elsewhere)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[3]
    if not (root / "pyproject.toml").exists():
        root = Path.cwd()
    return root / "build" / "repro_torch_kernels"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name], *HEADERS):
        h.update((CSRC / f).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together. Returns ``{name: {"seconds", "path", "log"}}``
    (``seconds`` 0.0 for a library that was already built; ``log`` is
    ptxas's register and spill report). Raises on a failed build."""
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    report = {}
    failed = []
    for name in names:
        if name not in procs:
            report[name] = {"seconds": 0.0, "path": str(library_path(name)),
                            "log": _read_log(library_path(name))}
            continue
        proc, tmp, lib = procs[name]
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        report[name] = {"seconds": time.perf_counter() - t0, "path": str(lib),
                        "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def _read_log(lib: Path) -> str:
    log = lib.with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if it is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib

"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries go to
``build/kernels/`` at the repository root, named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and an unchanged one is reused. ``build_all`` starts one ``nvcc`` per source at once and waits for
all of them. Nothing here runs at import time.
"""

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
KERNELS = ("kkt_schulz", "observe_ekf", "schulz_batch", "admm_iterations",
           "schulz_lanes", "schulz_balanced")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}
_load_lock = threading.Lock()


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name):
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=KERNELS):
    """Compile every kernel in ``names`` that has no current library, all
    ``nvcc`` processes at once. Returns {name: compiler log} for the
    sources it compiled; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def wrappers():
    """{kernel: its wrapper module ``ops/<kernel>.py``, which launches it
    and keeps its ``launches`` counter}."""
    return {name: importlib.import_module(f"{__package__}.{name}")
            for name in KERNELS}


def load(name):
    """The ctypes library of kernel ``name``, built first if needed (thread
    safe: the host loop's threads make first launches of their own)."""
    with _load_lock:
        if name not in _loaded:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]

"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so`` inside the
package, with a plain C interface. The hash covers the sources and the
flags, so a changed source is rebuilt and an unchanged one is loaded as it
is. Nothing is built at import: the first call of a kernel's wrapper builds
it, and `build_all` builds every source at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc failed; the message holds its stderr."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise BuildError("nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA "
                     "kernels of vmlmf_tpu_torch need the CUDA toolkit")


def sources() -> list[str]:
    """Names of the kernel sources in csrc/ (``<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is built; -> (proc, tmp, out) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise BuildError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                         f"{stderr}{stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all of it or none


def build_all() -> list[str]:
    """Build every source that is not built yet, all nvcc processes at once."""
    started = {n: _start(n) for n in sources()}
    errors = []
    for name, s in started.items():
        if s is None:
            continue
        try:
            _finish(name, s)
        except BuildError as e:
            errors.append(str(e))
    if errors:
        raise BuildError("\n".join(errors))
    return sorted(started)


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib

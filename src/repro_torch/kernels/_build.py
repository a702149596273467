"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each library is one or more ``csrc/*.cu`` files with a plain C interface
(``extern "C"`` launchers taking raw pointers and a stream, returning
``cudaGetLastError()``), compiled by hand for Hopper, one nvcc per source,
then linked into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c -o <object> <source>
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/kernels/<name>-<hash>.so <objects>

This takes seconds; PyTorch's own extension builder, whose sources include
PyTorch's headers, takes minutes.  Libraries are built at first use into
``build/kernels/`` under the repository root, keyed by a hash of their
sources, of every header (``*.cuh``) in their ``csrc/`` directories and of
the flags, so a fresh checkout builds everything itself and an edited
source or header is rebuilt.  `build_all` starts one nvcc per source of every
library, all at once.  A failed build raises with nvcc's stderr.

Nothing here runs when the module is imported: the CPU tests import every
module, and this machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["LIBRARIES", "BUILD_DIR", "load", "build_all", "build_logs"]

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

# library name -> its sources, relative to this directory
LIBRARIES: Dict[str, Tuple[str, ...]] = {
    "minplus": ("minplus/csrc/path_costs.cu", "minplus/csrc/minplus.cu",
                "minplus/csrc/minplus_dpx.cu"),
    "gf_crossprod": ("gf_crossprod/csrc/crossprod.cu",),
    "flash_attention": ("flash_attention/csrc/flash_attention.cu",
                        "flash_attention/csrc/flash_attention_sm90.cu",
                        "flash_attention/csrc/flash_attention_bwd.cu",
                        "flash_attention/csrc/flash_attention_bwd_sm90.cu"),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_loaded: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _target(name: str) -> Tuple[Path, List[Path]]:
    """The library's file, named by a hash of its flags, its sources and
    the headers beside them (which the sources include), and its sources."""
    sources = [_KERNELS / s for s in LIBRARIES[name]]
    headers = sorted({h for src in sources for h in src.parent.glob("*.cuh")})
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sources + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so", sources


def _run(cmd: List[str], name: str) -> subprocess.Popen:
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"nvcc not found ({cmd[0]}): cannot build the "
                           f"{name!r} kernels") from exc


def _start(name: str):
    """Start one nvcc a source of `name` unless its library is built;
    returns (target, [(object, process)]) or None when nothing needs
    building."""
    target, sources = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        obj = target.with_suffix(f".{os.getpid()}.{src.stem}.o")
        jobs.append((obj, _run([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                                str(src)], name)))
    return target, jobs


def _finish(name: str, started) -> None:
    target, jobs = started
    objs = [obj for obj, _ in jobs]
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        logs, errors = [], []
        for obj, proc in jobs:
            out, err = proc.communicate()
            logs.append(out + err)
            if proc.returncode != 0:
                errors.append(f"{obj.name} (exit {proc.returncode}):\n{err}")
        _logs[name] = "".join(logs)
        if errors:
            raise RuntimeError(f"nvcc failed to build the {name!r} kernels: "
                               + "\n".join(errors))
        link = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the {name!r} kernels "
                               f"(exit {link.returncode}):\n{link.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)


def build_all() -> None:
    """Build every library in `LIBRARIES` that is not built yet, one nvcc
    process per source, all started together."""
    started = {name: _start(name) for name in LIBRARIES}
    errors = []
    for name, st in started.items():
        if st is None:
            continue
        try:
            _finish(name, st)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def build_logs() -> Dict[str, str]:
    """nvcc's output (ptxas register and shared-memory report) for each
    library built by this process."""
    return dict(_logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        st = _start(name)
        if st is not None:
            _finish(name, st)
        lib = ctypes.CDLL(str(_target(name)[0]))
        _loaded[name] = lib
    return lib

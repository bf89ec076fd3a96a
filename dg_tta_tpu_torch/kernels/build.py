"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` exports a plain C function and is compiled by `nvcc`
for `sm_90a` into `build/torch_kernels/lib<name>_<hash>.so` under the
checkout's root, at first use, then loaded with `ctypes`.  The file name
carries a hash of the source, so an edited source is rebuilt and a stale
library is never loaded.  No source includes PyTorch's headers: `nvcc`
builds each one in seconds, where `torch.utils.cpp_extension.load` takes
minutes for a file that includes `torch/extension.h`.

Nothing here runs at import time; `nvcc` and a GPU are needed only when a
kernel is first launched.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           f"{CSRC} at first use and need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names) -> dict:
    """Compile the named sources that have no current library, one `nvcc`
    per source, all started together.  Returns {name: ptxas log} for the
    sources compiled in this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib

"""Build and load the port's CUDA kernel libraries.

Each kernel source under ``primekg_rgcn_tpu_torch/csrc/`` has a plain C
interface and is compiled by ``nvcc`` for ``sm_90a`` into a shared library
of its own in ``primekg_rgcn_tpu_torch/_build/``, named by a hash of its
source and the flags, at first use; the library is then loaded with
``ctypes``. A source may be built more than once with other ``-D`` defines
(B1 and B2: one library per row dtype, so that the two compile in
parallel). ``call_on_stream`` calls an entry point on the current stream
of a tensor's device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class CudaLibrary:
    """One kernel source, its library and its C entry points.

    ``functions`` maps each exported C function to its ``ctypes`` argument
    types; every entry returns a CUDA error code as ``int``. ``defines``
    are extra ``-D`` flags for this build of the source.
    """

    def __init__(self, source_name: str,
                 functions: Dict[str, Sequence[type]],
                 defines: Sequence[str] = ()):
        self.source = CSRC_DIR / source_name
        self.functions = dict(functions)
        self.flags = (*NVCC_FLAGS, *defines)
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        """Where the built library lives, keyed by a hash of source and
        flags."""
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def build(self, verbose: bool = False) -> Tuple[Path, str]:
        """Compile the library if it is not built yet. Returns its path and
        the compiler's output (with ``verbose``, ptxas's register and spill
        report); empty when the library was already there."""
        lib = self.library_path()
        if lib.exists():
            return lib, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *self.flags, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{lib.name}:\n{proc.stdout}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
        return lib, proc.stdout

    def load(self) -> ctypes.CDLL:
        """The loaded library with its entry points typed; builds it first
        when needed."""
        if self._lib is None:
            path, _ = self.build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def check_rc(rc: int, name: str) -> None:
    """Raise when a C entry point reports a refused launch."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def call_on_stream(entry, device: int, *args) -> int:
    """``entry(*args, stream)`` with ``stream`` the raw handle of the
    current stream of CUDA device ``device`` (an index, as
    ``Tensor.get_device()`` gives it), with that device current.

    This is the launch path of every wrapper, kept light: the raw handle
    costs well under a microsecond where ``torch.cuda.current_stream()``
    costs 3-8 us, and the current device is switched (2-3 us) only when it
    is not ``device`` already (PERF.md section 6)."""
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch._C._cuda_getDevice():
        return entry(*args, stream)
    with torch.cuda.device(device):
        return entry(*args, stream)

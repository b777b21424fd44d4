"""Build, load and launch the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout, at first use, and loaded
with ``ctypes``. The library's name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.

Nothing here runs when the module is imported: the CPU tests import every
module of the port, and this machine may have neither ``nvcc`` nor a card.
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
from typing import Iterable, List, Optional, Sequence

import torch

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")
    return path


class CudaKernel:
    """One C entry point of one ``.cu`` source, with its launch count.

    ``argtypes`` lists the ctypes of the arguments the wrapper passes; the
    stream is appended as the last argument. The C function returns a
    ``cudaError_t`` (0 on success) taken right after the launch.
    """

    def __init__(self, name: str, source: Path, symbol: str,
                 argtypes: Sequence[type]):
        self.name = name
        self.source = Path(source)
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._count_lock = threading.Lock()
        self.build_log = ""
        self._fn = None
        self._errstr = None

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this kernel unless its library is built."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.library)  # atomic: concurrent builders agree

    def _load(self):
        if self._fn is None:
            if not self.library.exists():
                build([self])
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            errstr = lib.kernel_error_string
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, errstr
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry point on ``device``'s current stream; raise on error."""
        fn = self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: launch failed: {self._errstr(err).decode()} ({err})"
            )
        with self._count_lock:  # ranks played by threads launch at once
            self.launches += 1


def build(kernels: Iterable[CudaKernel]) -> float:
    """Build every kernel not yet built, one ``nvcc`` each, all at once.

    Returns the wall seconds taken. Raises on the first failed build after
    every started ``nvcc`` has ended.
    """
    t0 = time.perf_counter()
    kernels = list(kernels)
    procs: List[Optional[subprocess.Popen]] = [k.start_build() for k in kernels]
    errors = []
    for k, p in zip(kernels, procs):
        try:
            k.finish_build(p)
        except RuntimeError as e:  # wait for the rest before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: Sequence[int], device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: device, dtype, shape, layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer must be 16-byte aligned")

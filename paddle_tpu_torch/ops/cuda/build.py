"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled on its own by `nvcc` for `sm_90a` into
`build/kernels/lib<name>-<digest>.so` at the repo root (the directory is
git-ignored) the first time a wrapper launches it, then loaded with
`ctypes`. The sources expose a plain C interface — no PyTorch headers —
so a build takes seconds, not minutes: pointers and the CUDA stream go
in as `c_void_p`, sizes as `c_int`, and every entry that launches returns
`cudaGetLastError()` as an int, which the wrapper checks with
:meth:`Kernel.check`.

The digest covers the source, every shared header (`csrc/*.cuh`) and
the flags, so an edited kernel is rebuilt and a stale library is never
loaded. Builds
write to a temporary name and rename, so processes building the same
kernel at once do not trip over each other.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

__all__ = ["Kernel", "build_all", "launch_stream", "CSRC", "BUILD_DIR",
           "REPO_ROOT"]

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C argument kinds of the kernels' entry signatures, and LONG, the return
# kind of an entry declared as (argtypes, LONG); every other entry returns
# an int
PTR, INT, FLOAT, LONG = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                         ctypes.c_longlong)
# element-type codes the entries take (DTYPE_F32 / DTYPE_BF16 in common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on the machine with the card")


class Kernel:
    """One CUDA source file, its C entry points and its launch count.

    ``entries`` maps each exported C function to its argument types, or
    to (argument types, return type) where it returns other than int.
    ``launches`` is a plain integer that the Python wrapper bumps once
    per kernel launch; callers reset it to 0 (or call :meth:`reset`)
    before a run they want to account. A source with several kernels
    for one function also counts each launch under the path it took
    (``paths``, by :meth:`count`). ``replaces`` is the file:line of the
    TPU kernel (the function that reaches `pl.pallas_call`) this one
    ports."""

    def __init__(self, name: str, entries: Dict[str, Sequence],
                 replaces: str):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.replaces = replaces
        self.launches = 0
        self.paths: Dict[str, int] = {}
        self.ptxas_log = ""
        self._entries = dict(entries)
        self._lib: Optional[ctypes.CDLL] = None
        self._fns: Dict[str, ctypes._CFuncPtr] = {}

    def count(self, path: str) -> None:
        """One launch, which took `path`."""
        self.launches += 1
        self.paths[path] = self.paths.get(path, 0) + 1

    def reset(self) -> None:
        """Zero the launch count and the counts by path."""
        self.launches = 0
        self.paths = {}

    # -- build --------------------------------------------------------------
    def lib_path(self) -> Path:
        h = hashlib.sha1()
        for part in (self.source, *sorted(CSRC.glob("*.cuh"))):
            h.update(part.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        """Start `nvcc` for this source unless its library is built;
        returns the process and its output file (None when there is
        nothing to build)."""
        out = self.lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, job: Tuple[subprocess.Popen, Path]) -> None:
        proc, tmp = job
        log, _ = proc.communicate()
        self.ptxas_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, self.lib_path())

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first when it is missing."""
        if self._lib is None:
            job = self.start_build()
            if job is not None:
                self.finish_build(job)
            lib = ctypes.CDLL(str(self.lib_path()))
            for fname, spec in self._entries.items():
                argtypes, restype = (spec if isinstance(spec, tuple)
                                     else (spec, ctypes.c_int))
                fn = getattr(lib, fname)
                fn.argtypes = list(argtypes)
                fn.restype = restype
                self._fns[fname] = fn
            err = lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def fn(self, entry: str):
        self.lib()
        return self._fns[entry]

    def check(self, err: int) -> None:
        """Raise when a C entry reported a CUDA error for its launch."""
        if err != 0:
            msg = self.lib().kernel_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed: {msg} "
                               f"(error {err})")


def build_all(kernels: Iterable[Kernel]) -> None:
    """Build every kernel that is not built yet, one `nvcc` per source,
    all started together, then load them."""
    kernels = list(kernels)
    jobs = [(k, k.start_build()) for k in kernels]
    failures = []
    for k, job in jobs:
        if job is not None:
            try:
                k.finish_build(job)
            except RuntimeError as e:
                failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    for k in kernels:
        k.lib()


def launch_stream(name: str, *tensors) -> int:
    """Validate the tensors one kernel launch reads or writes — all on
    the current CUDA device and contiguous — and return the handle of
    PyTorch's current stream there, the stream the kernel runs on."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    cur = torch.cuda.current_device()
    for t in tensors:
        if t.device != dev or (dev.index is not None and dev.index != cur):
            raise ValueError(f"{name}: every tensor must be on the current "
                             f"CUDA device cuda:{cur}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return torch.cuda.current_stream(dev).cuda_stream

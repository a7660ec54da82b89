"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``repro_torch/csrc/`` is a plain-C-interface file (no
PyTorch headers), compiled for Hopper into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

That takes seconds per file, against minutes for a source that includes
PyTorch's headers.  The first call builds every source at once, one
``nvcc`` process each, started together.  Libraries land in
``build/repro_torch/`` at the root of the checkout, named by the source's
content hash, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing is built at import time, and a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.backend import registry

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# each kernel's C entry point and its argument types (every pointer and the
# stream as c_void_p: left undeclared, ctypes would pass a 32-bit int)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
ENTRY_POINTS = {
    "circ_conv": ("circ_elem_launch",
                  [_P, _P, _P, _L, _I, _I, _L, _L, _L, _L, _I, _I, _P]),
    "qmatmul": ("qmatmul_launch", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "unbind_classify": ("unbind_classify_launch",
                        [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P]),
    "circ_dict": ("circ_dict_launch", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "simd_fused": ("match_prob_launch",
                   [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    "flash_attn": ("flash_attn_launch",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (where needed) and load every kernel source; returns
    ``{kernel name: library}``.  Records wall seconds per build in
    ``BUILD_SECONDS`` (0.0 for a library that was already built)."""
    names = [n for n in registry.KERNELS if n not in _LIBS]
    if not names:
        return dict(_LIBS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        src = CSRC / registry.KERNELS[name].source
        out = _target(src)
        if out.exists():
            BUILD_SECONDS[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name in names:
        lib = ctypes.CDLL(str(_target(CSRC / registry.KERNELS[name].source)))
        symbol, argtypes = ENTRY_POINTS[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return dict(_LIBS)


def entry(name: str):
    """The declared C entry point of kernel ``name`` (builds every source
    at first use)."""
    if name not in _LIBS:
        build_all()
    return getattr(_LIBS[name], ENTRY_POINTS[name][0])


def launch(name: str, index: int, *args) -> None:
    """Call kernel ``name``'s C entry point with ``args`` and the current
    stream of CUDA device ``index``, and raise on a launch error.  The
    kernel launches on the current device, so the device guard is entered
    only where ``index`` is not the current device; the stream is read on
    every call (``torch.cuda.current_stream`` builds a Stream object, some
    30 times the host time of reading the raw handle)."""
    fn = entry(name)
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(rc, name)


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")

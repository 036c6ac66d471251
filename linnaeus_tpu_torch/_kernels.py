"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
compiler process per source, all started together) and the objects are
linked into one shared library with a plain C interface, at first use,
loaded with ctypes. The library is written to ``build/linnaeus_tpu_torch/``
in the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. A missing ``nvcc`` or a
failed build raises: there is no fallback. The load is the
``setup/kernels`` span and a build inside it ``setup/kernels/build``, both
recorded whether tracing is on or not (utils/tracing.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from linnaeus_tpu_torch.utils.tracing import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "linnaeus_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "lt_flash_attention_fwd": [_P] * 5 + [_I] * 4 + [_L] * 9 + [_F, _I, _P],
    "lt_fused_mlp_fwd": [_P] * 11 + [_L, _I, _I, _F, _I, _I, _F, _F, _L, _P],
    "lt_fused_mlp_fwd_route": [_I, _I, _I],  # returns 1 (wgmma) or 0, not an error
    "lt_fused_mlp_bwd": [_P] * 3 + [_L, _I, _I, _F, _I, _I, _I, _I, _P, _F, _F, _L, _P],
    "lt_fused_mlp_bwd_route": [_I, _I, _I],  # returns 1 (wgmma) or 0, not an error
    "lt_flash_attention_bwd_delta": [_P] * 3 + [_I] * 4 + [_P, _I, _P],
    "lt_flash_attention_bwd_dq": [_P] * 7 + [_I] * 4 + [_P, _F, _I, _P],
    "lt_flash_attention_bwd_dkv": [_P] * 8 + [_I] * 4 + [_P, _F, _I, _P],
    "lt_fused_convnext_block_fwd": [_P] * 11 + [_I] * 5 + [_F, _I, _I, _P],
    "lt_fused_convnext_block_fwd_route": [_I, _I, _I],  # returns 1 (wgmma tail) or 0
    "lt_drop_path_add_fwd": [_P] * 4 + [_F, _F, _L, _L, _I, _P],
    "lt_drop_path_add_bwd": [_P] * 3 + [_F, _F, _L, _L, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "linnaeus_tpu_torch cannot be built"
    )


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libkernels-{digest.hexdigest()[:16]}.so"


def _run(cmd: list[str], proc: subprocess.Popen | None = None) -> str:
    """Wait for ``proc`` (or run ``cmd``) and return its output; raise on failure."""
    if proc is None:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{output}"
        )
    return output


def _build(out: Path, extra_flags: tuple[str, ...] = ()) -> str:
    """Compile every source (in parallel) and link ``out``; returns nvcc's output."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.with_name(f"{tag}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, proc, obj))
    tmp = out.with_name(f"{tag}.tmp")
    try:
        log = "".join(_run(cmd, proc) for cmd, proc, _ in jobs)
        _run([nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, _, obj in jobs)])
        os.replace(tmp, out)
    finally:
        for _, proc, obj in jobs:
            proc.kill()  # no-op for a compiler that has exited
            proc.wait()
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return log


def resource_usage() -> str:
    """Build the sources once more with ``-Xptxas -v`` into a scratch
    library and return nvcc's report (registers, shared memory and spills
    of every kernel)."""
    scratch = BUILD_DIR / "libkernels-ptxas-report.so"
    try:
        return _build(scratch, ("-Xptxas", "-v"))
    finally:
        scratch.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            with span("setup/kernels", always=True):
                path = library_path()
                if not path.is_file():
                    with span("setup/kernels/build", always=True):
                        _build(path)
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.lt_error_string.argtypes = [ctypes.c_int]
                lib.lt_error_string.restype = ctypes.c_char_p
                _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a non-zero cudaError_t."""
    if err != 0:
        text = library().lt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

"""Builds the port's CUDA kernels with `nvcc` and loads them with `ctypes`.

Each source in `llm_qat_tpu_torch/csrc/` is compiled on its own into a
shared library with a plain C interface, for `sm_90a`, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -lineinfo -Xptxas -v \
         -o build/kernels/lib<name>-<hash>.so <name>.cu

The library lands in `build/kernels/` at the checkout's root (listed in
`.gitignore`); its file name carries a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source or header is
rebuilt. What nvcc printed (ptxas's registers, shared
memory and spills per kernel) is kept beside it (`ptxas_report`). Nothing is built when a module is imported.
`build_all()` starts one `nvcc` per source at once and waits for all.
`load()` sets the argument types of each library's entry points once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v"]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source name -> {C entry point: argument types}; each returns a CUDA error
# code (0 on success)
KERNELS: Dict[str, Dict[str, list]] = {
    "flash_attention": {
        "flash_forward": [_P] * 5 + [_I] * 5 + [_F, _P],
        "flash_forward_wgmma": [_P] * 5 + [_I] * 3 + [_F, _P],
        "flash_bwd": [_P] * 10 + [_I] * 4 + [_F, _P],
        "flash_bwd_wgmma": [_P] * 10 + [_I] * 3 + [_F, _P]},
    "mega_decode": {
        "mega_decode_step_kv": [_P] * 23 + [_I] * 15 + [_F] * 3 + [_P],
        "mega_decode_step_f": [_P] * 21 + [_I] * 16 + [_F] * 3 + [_P],
        "mega_decode_step_cb": [_P] * 28 + [_I] * 16 + [_F] * 3 + [_P],
        "mega_step_grid": [_P],
        "mega_phase_clock": [_P]},
    "decode_attention": {
        "decode_attention_hbm": [_P] * 7 + [_I] * 8 + [_F, _P],
        "decode_attention_dense": [_P] * 7 + [_I] * 6 + [_F, _P]},
    "fused_linear": {
        "fused_linear_fq_weight": [_P] * 7 + [_I] * 5 + [_F, _P],
        "fused_linear_fwd_wgmma": [_P] * 10 + [_I] * 5 + [_F, _P],
        "fused_linear_bwd_dx_wgmma": [_P] * 9 + [_I] * 5 + [_F, _P],
        "fused_linear_fwd_f32": [_P] * 9 + [_I] * 5 + [_F, _P],
        "fused_linear_bwd_dx_f32": [_P] * 8 + [_I] * 5 + [_F, _P],
        "fused_linear_bwd_dw_f32": [_P] * 4 + [_I] * 3 + [_P],
        "fused_linear_bwd_dw_wgmma": [_P] * 4 + [_I] * 4 + [_P, _P]},
    "quant_matmul": {
        "quant_matmul": [_P] * 4 + [_I] * 6 + [_P]},
    "fused_decode": {
        "fused_ln_qkv": [_P] * 14 + [_I] * 6 + [_F, _P],
        "fused_post_attention": [_P] * 25 + [_I] * 6 + [_F, _P],
        "fused_phase_clock": [_P]},
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("llm_qat_tpu_torch: nvcc not found; the CUDA kernels "
                       "are built on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # every shared header too: a source that includes an edited one is rebuilt
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    h = hashlib.sha1(src + " ".join(ARCH + BASE_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH, *BASE_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):"
                           f"\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a torn file


def build_all() -> None:
    """Compile every kernel source in parallel (one nvcc each)."""
    jobs = {name: _start(name) for name in KERNELS}
    errors = []
    for name, job in jobs.items():
        try:
            _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def ptxas_report(name: str) -> str:
    """ptxas's lines (registers, shared memory, spills per kernel) from
    the build of kernel source `name`, built if missing."""
    _finish(name, _start(name))
    log = _lib_path(name).with_suffix(".log").read_text()
    return "\n".join(line for line in log.splitlines()
                     if "registers" in line or "spill" in line or "Compiling" in line)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source `name`, built if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        for fn_name, argtypes in KERNELS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of t's device, as the entry
    points take it: kernels launch on PyTorch's current stream."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernels_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")

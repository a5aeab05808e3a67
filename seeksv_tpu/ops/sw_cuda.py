"""The batched extension DP as a CUDA kernel (csrc/sw_extend.cu), called
through the XLA foreign function interface on NVIDIA Hopper cards.

One warp per job, the query axis split over the 32 lanes (LANE_CELLS[c]
cells each, kept in registers), target rows looped inside the kernel,
and each job stopped at its own z-drop.  Semantics are exactly those of
ops.jax_kernels.sw_extend_batch and io.native.sw_extend_batch_native;
the kernel has no interpret mode, so the tests keep the arithmetic on
those references and test this module's shapes, padding and cell menu.

The shared library is built from the committed source with `nvcc` at
first use into csrc/build/ (listed in .gitignore).
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

TARGET = "seeksv_sw_extend"
LANES = 32
# query cells per lane with a compiled kernel (csrc/sw_extend.cu SwExtendImpl)
LANE_CELLS = (1, 2, 4, 8, 16, 32, 48, 64)
MAX_LQ = LANES * LANE_CELLS[-1]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_SRC = os.path.join(_CSRC, "sw_extend.cu")
_LIB = os.path.join(_CSRC, "build", "libseeksv_sw_cuda.so")


def lane_cells(LQ: int) -> int:
    """Cells per lane for a query width: the smallest menu entry whose
    32 lanes cover LQ.  Raises for widths above MAX_LQ."""
    for c in LANE_CELLS:
        if LANES * c >= LQ:
            return c
    raise ValueError(f"query width {LQ} exceeds the kernel's {MAX_LQ}")


def _nvcc() -> str:
    import shutil
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA extension kernel cannot "
                       "be built on this machine")


def build() -> str:
    """Compile the kernel library when it is missing or older than its
    source; returns its path.  The output lands by atomic rename, so a
    concurrent builder never exposes a torn library."""
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    import subprocess
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.tmp{os.getpid()}"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, _LIB)
    return _LIB


@functools.lru_cache(maxsize=1)
def ensure_registered() -> None:
    """Build and load the library, and register its handler with XLA
    for the CUDA platform (once per process)."""
    import ctypes
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.SeeksvSwExtend),
                                platform="CUDA")


def _ffi_extend(q8, t8, qlen, tlen, h0):
    B = q8.shape[0]
    outs = jax.ffi.ffi_call(
        TARGET, [jax.ShapeDtypeStruct((B,), jnp.int32)] * 5)(
            q8, t8, qlen, tlen, h0)
    return dict(zip(("max_score", "qle", "tle", "gscore", "gtle"), outs))


@jax.jit
def sw_extend_cuda(q, qlen, t, tlen, h0):
    """Batched extension on the CUDA kernel.  Arguments and results as
    ops.jax_kernels.sw_extend_batch.  The query is padded with code 4 to
    the kernel's width (32 * lane_cells(LQ)); padded cells lie past qlen
    and are masked.  Queries wider than MAX_LQ take the XLA form."""
    LQ = q.shape[1]
    if LQ > MAX_LQ:
        from .jax_kernels import sw_extend_batch
        return sw_extend_batch(q, qlen, t, tlen, h0)
    width = LANES * lane_cells(LQ)
    q8 = jnp.pad(q.astype(jnp.int8), ((0, 0), (0, width - LQ)),
                 constant_values=4)
    return _ffi_extend(q8, t.astype(jnp.int8), qlen.astype(jnp.int32),
                       tlen.astype(jnp.int32), h0.astype(jnp.int32))

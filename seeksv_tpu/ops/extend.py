"""Which device kernels run, chosen from the observed JAX backend, and
the single-card resident-target form of the batched extension.

This module is the one place that looks at the backend's platform:
  platform()        the default backend's platform ("cpu", "gpu", ...).
  on_accelerator()  whether the default backend is a device at all, i.e.
                    whether the calibrated host/device dispatch may route
                    work there.
  extend_kernel()   the batched extension DP: the CUDA kernel
                    (ops.sw_cuda) on "gpu", XLA's scan
                    (ops.jax_kernels.sw_extend_batch) everywhere else;
                    under a mesh, wrapped in shard_map over the job axis.
The finalize stage's banded DP and traceback (ops.global_device) run as
plain XLA on every backend.

None of these catch a backend failure: a GPU backend that fails to start
raises here instead of passing for "no accelerator".
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def platform() -> str:
    return jax.devices()[0].platform


def on_accelerator() -> bool:
    return platform() != "cpu"


def extend_kernel(plat: str, mesh=None):
    """The batched extension callable (q, qlen, t, tlen, h0) -> dict of
    [B] int32 (max_score, qle, tle, gscore, gtle) for backend `plat`.
    With a mesh, every argument's leading (job) axis is split over all
    mesh axes and each device runs the kernel on its own jobs."""
    if plat == "gpu":
        from .sw_cuda import ensure_registered, sw_extend_cuda as fn
        ensure_registered()
    else:
        from .jax_kernels import sw_extend_batch as fn
    if mesh is not None:
        fn = _shard_jobs(fn, mesh)
    return fn


@functools.lru_cache(maxsize=16)
def _shard_jobs(fn, mesh):
    from jax.sharding import PartitionSpec

    spec = PartitionSpec(tuple(mesh.axis_names))
    # an FFI call cannot be partitioned by XLA, so each device gets its
    # shard explicitly; the jobs are independent, nothing is exchanged
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 5,
                                 out_specs=spec, check_vma=False))


# ---- resident-target form ------------------------------------------------
# Codes are 0..4, so two fit per byte: queries upload nibble-packed, and
# target windows are not uploaded at all -- they are gathered on device
# from a nibble-packed copy of the reference that stays resident for the
# process.

def pack_nibbles(a):
    """[B, L] uint8 codes (0..4) -> [B, ceil(L/2)] uint8, host side."""
    B, L = a.shape
    if L % 2:
        a = np.concatenate([a, np.full((B, 1), 4, np.uint8)], axis=1)
    return (a[:, 0::2] | (a[:, 1::2] << 4)).astype(np.uint8)


def _unpack_nibbles(p, L):
    """[B, ceil(L/2)] uint8 -> [B, L] int8 (device side)."""
    lo = (p & 0xF).astype(jnp.int8)
    hi = (p >> 4).astype(jnp.int8)
    return jnp.stack([lo, hi], axis=2).reshape(p.shape[0], -1)[:, :L]


def _gather_ref_windows(refp, n_codes, start, tlen, LT, reverse):
    """Gather [B, LT] int8 target windows from the packed reference.
    start is the absolute genome index of the window's FIRST element in
    scan order; reverse=True walks backwards (left-extension windows are
    reversed reference slices).  Out-of-range / beyond-tlen positions
    read as 4 (ambiguous, never matches)."""
    B = start.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (B, LT), 1)
    idx = start[:, None] + (-iota if reverse else iota)
    valid = (iota < tlen[:, None]) & (idx >= 0) & (idx < n_codes)
    idx_c = jnp.clip(idx, 0, n_codes - 1)
    byte = refp[idx_c >> 1]
    nib = jnp.where((idx_c & 1) == 1, byte >> 4, byte & 0xF).astype(jnp.int8)
    return jnp.where(valid, nib, jnp.int8(4))


@functools.partial(jax.jit,
                   static_argnames=("kernel", "LQ", "LT", "reverse"))
def extend_resident(kernel, q4, qlen, tstart, tlen, h0, refp, n_codes,
                    LQ, LT, reverse):
    """`kernel` (from extend_kernel) on nibble-packed queries and target
    windows gathered from the resident packed reference.  Same results
    as `kernel` on the corresponding expanded windows."""
    q = _unpack_nibbles(q4, LQ)
    t = _gather_ref_windows(refp, n_codes, tstart, tlen, LT, reverse)
    return kernel(q, qlen, t, tlen, h0)

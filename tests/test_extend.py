"""The kernel chooser (ops.extend), the CUDA wrapper's shapes and padding
(ops.sw_cuda, traced without CUDA), the resident-target gather, and the
XLA extension scan against the native host kernel at the long-fragment
shape.  The CUDA kernel's own arithmetic runs only on the card
(`gpu`-marked tests below, and chip_smoke.py phase b)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from seeksv_tpu.ops import extend as ext
from seeksv_tpu.ops import sw_cuda
from seeksv_tpu.ops.jax_kernels import sw_extend_batch

OUTS = ("max_score", "qle", "tle", "gscore", "gtle")


def _jobs(rng, B, LQ, LT, identity=0.9):
    """Random extension jobs; even rows copy their target with a few
    substitutions (long matches), odd rows are random (early z-drop)."""
    q = np.full((B, LQ), 4, np.int8)
    t = np.full((B, LT), 4, np.int8)
    qlen = rng.integers(0, LQ + 1, B).astype(np.int32)
    tlen = rng.integers(1, LT + 1, B).astype(np.int32)
    h0 = rng.integers(10, 60, B).astype(np.int32)
    for b in range(B):
        tc = rng.integers(0, 4, tlen[b])
        qc = rng.integers(0, 4, qlen[b])
        if b % 2 == 0:
            n = min(qlen[b], tlen[b])
            qc[:n] = tc[:n]
            mut = rng.random(n) > identity
            qc[:n][mut] = rng.integers(0, 4, int(mut.sum()))
        q[b, :qlen[b]] = qc
        t[b, :tlen[b]] = tc
    return q, qlen, t, tlen, h0


def _assert_same(got, want, msg=""):
    for k in OUTS:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=f"{k} {msg}")


def test_chooser_cpu_gives_xla_scan():
    assert ext.extend_kernel("cpu") is sw_extend_batch


def test_chooser_gpu_gives_cuda_target(monkeypatch):
    """On "gpu" the chooser registers and returns the FFI wrapper; traced
    here without CUDA, the wrapper pads the query to the kernel's lane
    width and calls the registered target with int8 codes."""
    calls = []
    monkeypatch.setattr(sw_cuda, "ensure_registered",
                        lambda: calls.append(1))
    fn = ext.extend_kernel("gpu")
    assert fn is sw_cuda.sw_extend_cuda and calls == [1]
    B, LQ, LT = 6, 150, 300
    args = (np.zeros((B, LQ), np.int8), np.zeros(B, np.int32),
            np.zeros((B, LT), np.int8), np.zeros(B, np.int32),
            np.zeros(B, np.int32))
    text = str(jax.make_jaxpr(fn)(*args))
    assert "target_name=seeksv_sw_extend" in text
    assert f"i8[{B},256]" in text          # 150 -> 32 lanes x 8 cells
    out = jax.eval_shape(fn, *args)
    assert {k: (v.shape, v.dtype) for k, v in out.items()} == {
        k: ((B,), jnp.int32) for k in OUTS}


@pytest.mark.parametrize("LQ,cells", [(1, 1), (32, 1), (33, 2), (128, 4),
                                      (129, 8), (512, 16), (1024, 32),
                                      (1025, 48), (1536, 48), (2048, 64)])
def test_lane_cells_menu(LQ, cells):
    assert sw_cuda.lane_cells(LQ) == cells
    assert cells in sw_cuda.LANE_CELLS and 32 * cells >= LQ


def test_cuda_wrapper_wide_query_takes_xla():
    """Queries wider than the kernel's menu take XLA's scan: no FFI call
    in the trace, and the results are the scan's."""
    with pytest.raises(ValueError):
        sw_cuda.lane_cells(sw_cuda.MAX_LQ + 1)
    rng = np.random.default_rng(2)
    args = _jobs(rng, 4, sw_cuda.MAX_LQ + 64, sw_cuda.MAX_LQ + 96)
    assert "ffi_call" not in str(jax.make_jaxpr(sw_cuda.sw_extend_cuda)(
        *args))
    _assert_same(sw_cuda.sw_extend_cuda(*args), sw_extend_batch(*args))


def test_chooser_mesh_wraps_in_shard_map():
    """Under a mesh the kernel runs per device on its own jobs
    (shard_map over the job axis); results equal the unsharded call."""
    from seeksv_tpu.parallel import make_mesh
    mesh = make_mesh(4)
    fn = ext.extend_kernel("cpu", mesh)
    assert fn is not sw_extend_batch
    rng = np.random.default_rng(4)
    args = _jobs(rng, 16, 40, 90)
    assert "shard_map" in str(jax.make_jaxpr(fn)(*args))
    _assert_same(fn(*args), sw_extend_batch(*args))


@pytest.mark.parametrize("reverse", [False, True])
def test_resident_gather_matches_expanded_windows(reverse):
    """Nibble-packed queries + target windows gathered from the resident
    packed reference, through the chosen (CPU) kernel, equal the kernel
    on the expanded windows; left windows walk backwards and windows
    running off the genome read as ambiguous."""
    rng = np.random.default_rng(11 + reverse)
    G = 5_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[rng.random(G) < 0.01] = 4
    refp = jnp.asarray(ext.pack_nibbles(genome[None, :])[0])
    B, LQ, LT = 64, 40, 80
    kern = ext.extend_kernel(ext.platform())
    q = np.full((B, LQ), 4, np.uint8)
    qlen = rng.integers(0, LQ + 1, B).astype(np.int32)
    tlen = rng.integers(1, LT + 1, B).astype(np.int32)
    h0 = rng.integers(10, 40, B).astype(np.int32)
    start = rng.integers(0, G, B).astype(np.int32)
    start[:4] = [0, 1, G - 1, G - 2]
    t = np.full((B, LT), 4, np.int8)
    for b in range(B):
        q[b, :qlen[b]] = rng.integers(0, 4, qlen[b])
        for j in range(tlen[b]):
            i = start[b] - j if reverse else start[b] + j
            if 0 <= i < G:
                t[b, j] = genome[i]
    want = kern(q.astype(np.int8), qlen, t, tlen, h0)
    got = ext.extend_resident(kern, ext.pack_nibbles(q), qlen, start, tlen,
                              h0, refp, G, LQ, LT, reverse)
    _assert_same(got, want, f"reverse={reverse}")


def test_xla_scan_matches_native_long_fragment_shape():
    """XLA's scan against the threaded C++ host kernel at the virus
    workload's bucket (LQ=1024, LT=1536), small batch."""
    from seeksv_tpu.io import native
    if not native.sw_available():
        pytest.skip("native host kernels not built")
    rng = np.random.default_rng(8)
    q, qlen, t, tlen, h0 = _jobs(rng, 6, 1024, 1536, identity=0.96)
    qlen[:3] = [1024, 1000, 0]
    tlen[:3] = [1536, 1100, 50]
    want = native.sw_extend_batch_native(q, qlen, t, tlen, h0)
    _assert_same(sw_extend_batch(q, qlen, t, tlen, h0), want)


@pytest.fixture
def gpu():
    if ext.platform() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "SEEKSV_TPU_TESTS_ON_DEVICE=1 pytest -m gpu)")


@pytest.mark.gpu
@pytest.mark.parametrize("LQ,LT", [(32, 96), (128, 256), (1024, 1536)])
def test_cuda_kernel_matches_native(gpu, LQ, LT):
    from seeksv_tpu.io import native
    rng = np.random.default_rng(LQ)
    args = _jobs(rng, 512, LQ, LT, identity=0.95)
    _assert_same(ext.extend_kernel("gpu")(*args),
                 native.sw_extend_batch_native(*args), f"LQ={LQ}")

// Batched anchored affine-gap extension (the realignment engine's hot
// loop) for Hopper, called from JAX through the XLA FFI as
// "seeksv_sw_extend".
//
// Semantics are exactly those of seeksv_sw_extend_batch in
// seeksv_native.cpp (and of ops/jax_kernels.sw_extend_batch): bwa-mem
// scoring, lazy-F row gaps, first-occurrence row argmax, z-drop stop.
//
// Layout: one warp per job.  The query axis is split into 32 contiguous
// chunks of C cells, one chunk per lane, held in registers for the whole
// job; the kernel loops over target rows and stops a job at its z-drop.
// Per row the in-row gap recurrence F[j] = max_{k<j}(G[k] + k*ext) -
// open - j*ext is a lane-local running max plus one warp shuffle scan of
// the lane maxima.  Inputs: q [B, 32*C] int8 codes (4 = pad/ambiguous),
// t [B, LT] int8, qlen/tlen/h0 [B] int32.  Results: five [B] int32.
//
// Build (done at first use by seeksv_tpu/ops/sw_cuda.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libseeksv_sw_cuda.so sw_extend.cu

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kMatch = 1;
constexpr int32_t kMismatch = 4;
constexpr int32_t kGapOpen = 6;
constexpr int32_t kGapExt = 1;
constexpr int32_t kAmbig = -1;
constexpr int32_t kNegInf = -0x40000000;  // seeksv_native.cpp kNegInf
constexpr int32_t kZdrop = 100;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

template <int C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_extend_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                 const int32_t* __restrict__ qlen,
                 const int32_t* __restrict__ tlen,
                 const int32_t* __restrict__ h0v, int64_t B, int64_t LT,
                 int32_t* __restrict__ o_best, int32_t* __restrict__ o_qle,
                 int32_t* __restrict__ o_tle, int32_t* __restrict__ o_gscore,
                 int32_t* __restrict__ o_gtle) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform: the whole warp leaves together
  const int32_t m = qlen[b];
  const int32_t n = tlen[b] < LT ? tlen[b] : (int32_t)LT;
  const int32_t h0 = h0v[b];
  const int32_t j0 = lane * C + 1;  // 1-based query index of cell 0

  // query codes, four per register
  constexpr int NW = (C + 3) / 4;
  uint32_t qp[NW];
  const int8_t* qrow = q + b * (int64_t)(32 * C) + (j0 - 1);
#pragma unroll
  for (int w = 0; w < NW; ++w) qp[w] = 0;
#pragma unroll
  for (int k = 0; k < C; ++k)
    qp[k >> 2] |= (uint32_t)(uint8_t)qrow[k] << ((k & 3) * 8);

  int32_t h[C], e[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int32_t j = j0 + k;
    const int32_t v = h0 - kGapOpen - j * kGapExt;
    h[k] = (j <= m && v >= 0) ? v : kNegInf;
    e[k] = kNegInf;
  }

  int32_t best = h0, qle = 0, tle = 0, gscore = kNegInf, gtle = 0;
  int32_t hcol = h0;  // H[i-1][0]
  const int8_t* trow = t + b * LT;
  int32_t tvec = 4;
  for (int32_t i = 1; i <= n; ++i) {
    // 32 target codes per load, handed out by shuffle
    if (((i - 1) & 31) == 0) {
      const int32_t ti = i - 1 + lane;
      tvec = ti < n ? (int32_t)trow[ti] : 4;
    }
    const int32_t tb = __shfl_sync(kFull, tvec, (i - 1) & 31);

    // pass 1: G = max(diag, E) and the lane's max of G[j] + j*ext
    int32_t left = __shfl_up_sync(kFull, h[C - 1], 1);
    if (lane == 0) left = hcol;
    int32_t umax = kNegInf;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int32_t qk = (int32_t)((qp[k >> 2] >> ((k & 3) * 8)) & 0xff);
      const int32_t sub =
          (qk > 3 || tb > 3) ? kAmbig : (qk == tb ? kMatch : -kMismatch);
      const int32_t diag = left + sub;
      left = h[k];
      const int32_t ecand = max(h[k] - kGapOpen, e[k]) - kGapExt;
      const int32_t g = max(diag, ecand);
      h[k] = g;
      e[k] = ecand;
      umax = max(umax, g + (j0 + k) * kGapExt);
    }
    // exclusive max-scan of the lane maxima across the warp
    int32_t incl = umax;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, o);
    }
    int32_t run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = kNegInf;

    // pass 2: H = max(G, F), row best (first occurrence) and H[i][m]
    int32_t rb = kNegInf, ra = 0, hq = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int32_t j = j0 + k;
      const int32_t g = h[k];
      const int32_t nh = max(g, run - kGapOpen - j * kGapExt);
      run = max(run, g + j * kGapExt);
      const bool valid = j <= m;
      h[k] = valid ? nh : kNegInf;
      e[k] = valid ? e[k] : kNegInf;
      if (valid && nh > rb) {
        rb = nh;
        ra = j;
      }
      if (j == m) hq = nh;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int32_t ov = __shfl_xor_sync(kFull, rb, d);
      const int32_t oa = __shfl_xor_sync(kFull, ra, d);
      if (ov > rb || (ov == rb && oa < ra)) {
        rb = ov;
        ra = oa;
      }
    }
    const int32_t h0_col = h0 - kGapOpen - i * kGapExt;
    const int32_t owner = m > 0 ? (m - 1) / C : 0;
    hq = __shfl_sync(kFull, hq, owner);
    const int32_t h_at_qlen = m == 0 ? h0_col : hq;
    hcol = h0_col;
    if (rb > best) {
      best = rb;
      qle = ra;
      tle = i;
    }
    if (h_at_qlen > gscore) {
      gscore = h_at_qlen;
      gtle = i;
    }
    if (rb < best - kZdrop) break;  // warp-uniform
  }
  if (lane == 0) {
    o_best[b] = best;
    o_qle[b] = qle;
    o_tle[b] = tle;
    o_gscore[b] = gscore;
    o_gtle[b] = gtle;
  }
}

template <int C>
void launch(cudaStream_t s, const int8_t* q, const int8_t* t,
            const int32_t* qlen, const int32_t* tlen, const int32_t* h0,
            int64_t B, int64_t LT, int32_t* o0, int32_t* o1, int32_t* o2,
            int32_t* o3, int32_t* o4) {
  const int64_t blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sw_extend_kernel<C><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, s>>>(
      q, t, qlen, tlen, h0, B, LT, o0, o1, o2, o3, o4);
}

ffi::Error SwExtendImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> q,
                        ffi::Buffer<ffi::S8> t, ffi::Buffer<ffi::S32> qlen,
                        ffi::Buffer<ffi::S32> tlen, ffi::Buffer<ffi::S32> h0,
                        ffi::ResultBuffer<ffi::S32> best,
                        ffi::ResultBuffer<ffi::S32> qle,
                        ffi::ResultBuffer<ffi::S32> tle,
                        ffi::ResultBuffer<ffi::S32> gscore,
                        ffi::ResultBuffer<ffi::S32> gtle) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  if (qd.size() != 2 || td.size() != 2 || qd[0] != td[0])
    return ffi::Error::InvalidArgument("q and t must be [B, L] arrays");
  const int64_t B = qd[0], LQ = qd[1], LT = td[1];
  if (B == 0) return ffi::Error::Success();
  if (LQ % 32 != 0)
    return ffi::Error::InvalidArgument("query width must be 32 * C");
  const int8_t* qp = q.typed_data();
  const int8_t* tp = t.typed_data();
  const int32_t* ql = qlen.typed_data();
  const int32_t* tl = tlen.typed_data();
  const int32_t* hp = h0.typed_data();
  int32_t* o0 = best->typed_data();
  int32_t* o1 = qle->typed_data();
  int32_t* o2 = tle->typed_data();
  int32_t* o3 = gscore->typed_data();
  int32_t* o4 = gtle->typed_data();
  // the menu mirrors ops/sw_cuda.LANE_CELLS
  switch (LQ / 32) {
#define SEEKSV_CASE(C)                                                     \
  case C:                                                                  \
    launch<C>(stream, qp, tp, ql, tl, hp, B, LT, o0, o1, o2, o3, o4);      \
    break;
    SEEKSV_CASE(1)
    SEEKSV_CASE(2)
    SEEKSV_CASE(4)
    SEEKSV_CASE(8)
    SEEKSV_CASE(16)
    SEEKSV_CASE(32)
    SEEKSV_CASE(48)
    SEEKSV_CASE(64)
#undef SEEKSV_CASE
    default:
      return ffi::Error::InvalidArgument("unsupported query width");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SeeksvSwExtend, SwExtendImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

// One whole AuxIVA-IP iteration for C = N = 2 (kernel K2), in one launch.
//
// Per bin f, from the previous iteration's frame power sums psum (2, T):
//   winv[n, t] = 1 / max(sqrt(psum[n, t]), eps)     (Laplace contrast)
//              = 1 / max(psum[n, t] / F, eps)        (Gauss contrast)
//   U_n        = (1/T) sum_t winv[n, t] x x^H          (4 planes x 2 sources)
//   for n = 0, 1 (sequential rows):
//     w    = (W U_n)^{-1} e_n                          (2x2 adjugate)
//     keep the old row unless kappa_1(W U_n) < threshold
//     W[n] = conj(w) / sqrt(w^H U_n w)                 (Cholesky sum of squares)
// and then, for the next iteration and this iteration's loss,
//   psum'[n, t] = sum_f |sum_c W[n, c] x_c|^2,   logdet = sum_f log|det W_f|,
//   nll         = 2 sum sqrt(psum') - 2 T logdet                 (Laplace)
//               = F sum log max(psum' / F, eps) - 2 T logdet     (Gauss).
// The estimates Y are never written to device memory.  The contrast is a
// template parameter: it changes the weights and the NLL's per-column term
// and nothing else (the launch plan, shared memory and summation order are
// the same for both).
//
// Replaces audio_source_separation_tpu/ops/pallas_fused.py::_iter_kernel
// (pallas_call in fused_auxiva_ip_iter).  Where the Pallas design does not
// carry over:
//  * Cross-tile sums.  The TPU kernel accumulates psum and logdet in one
//    block that every sequential grid step revisits.  Here the grid is
//    launched cooperatively with as many blocks as fit on the card at once
//    (at most one per group of B bins), each taking every gridDim-th group
//    and adding its groups' |W x|^2 frame sums and logdet into its own
//    partial row.  After one grid-wide barrier, each block sums 32 columns
//    at a time over all rows (warp w a fixed run of rows, then the runs in
//    warp order) and writes psum; the last block to take a ticket sums the
//    blocks' shares of sum sqrt(psum) in a fixed tree and writes logdet and
//    the NLL.  The order depends only on the grid, and there are no float
//    atomics, so every launch gives the same bits.  The barrier's counter
//    and the ticket are left at 0 for the next launch.
//  * w^H U w uses the closed-form 2x2 Cholesky sum of squares of
//    ops/ip_components.py::cholesky_quadratic_components, which cannot go
//    negative in float32 (the Pallas body's direct sum can).
//  * The Pallas kernel takes the weights 1/R as an input and leaves the
//    contrast and the NLL to its caller; here both contrasts' weights are
//    computed from psum in the kernel, and the NLL in its tail.
//  * eps and threshold are the solver's, passed by the wrapper.
//  * Ragged edges are masked in the kernel: no padded copies of X.
//  * An all-zero bin has a singular U, so det = 0 and the inverse is NaN;
//    the kappa_1 comparison is false on NaN and the old rows are kept, and
//    the bin adds |W x|^2 = 0 to psum.  This relies on IEEE NaN semantics:
//    never build with fast math.
//  * Shared memory.  The Pallas tile (4, 128, 512) f32 does not fit a
//    Hopper block.  A group is B consecutive bins, B in {2, 4, 8}, chosen
//    from T by ops/fused_ip.py::k2_launch_plan.  When a group's slab (2
//    channels x B bins x T complex64) fits in shared memory it is resident:
//    lane g of warp 0 issues 1-D bulk copies (TMA, cp.async.bulk) of pair g
//    of bins, both channels, on mbarrier g (one phase per group the block
//    takes), so the whole slab is in flight at once; each warp starts its
//    bin's covariance as its pair lands, and the separation reads the slab,
//    so X is read from device memory once.  A pair of bins of one channel
//    is one contiguous run of 16 T bytes; where it does not start or end on
//    16 bytes (odd F T), the 8-byte element at that end is loaded by a plain
//    load.  Above that size (T > 6943) the slab is streamed in groups of 8
//    bins: the warps read X from device memory for the covariance and
//    again for the separation.  The weights are staged kChunk frames at a
//    time, so any T fits.
//  * Work per block: 8 warps; 8 / B warps per bin share its frames in the
//    covariance; the IP update runs for all B bins at once, one lane
//    of warp 0 per bin, on the old rows loaded at the start; the separation
//    gives each thread a frame and the new rows in registers.
//
// Bound: X is read once from device memory, 8*2*F*T bytes; at F = 2049,
// T = 469 that is 15.4 MB, about 4.6 us at 3.35 TB/s, and the arithmetic
// (about 70 flops per (f, t)) is far below the card's float32 rate, so the
// bound is bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no fast math).  With -DK2_TIMELINE, thread 0 of every
// block also stamps %globaltimer at the boundaries of the kernel's phases
// (K2_STAMP below), read back by k2_stamps; tools/k2_timeline.py builds
// and reads that variant.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"

namespace {

using namespace hopper;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;  // frames of weights staged per pass
constexpr int kMaxDevices = 64;

#ifdef K2_TIMELINE
constexpr int kStamps = 16;  // per block
constexpr int kStampBlocks = 4096;  // above any grid K2 launches
__device__ unsigned long long g_stamps[kStampBlocks * kStamps];
#define K2_STAMP(k)                                                                \
  do {                                                                             \
    if (threadIdx.x == 0) {                                                        \
      unsigned long long t;                                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                        \
      g_stamps[blockIdx.x * kStamps + (k)] = t;                                    \
    }                                                                              \
  } while (0)
#else
#define K2_STAMP(k) \
  do {              \
  } while (0)
#endif

struct cf {
  float re, im;
};

__device__ __forceinline__ cf make(float re, float im) { return {re, im}; }
__device__ __forceinline__ cf add(cf a, cf b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ cf sub(cf a, cf b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ cf neg(cf a) { return {-a.re, -a.im}; }
__device__ __forceinline__ cf cconj(cf a) { return {a.re, -a.im}; }
__device__ __forceinline__ cf mul(cf a, cf b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ cf scale(cf a, float s) { return {a.re * s, a.im * s}; }
__device__ __forceinline__ float cmag(cf a) { return hypotf(a.re, a.im); }
__device__ __forceinline__ float abs2(cf a) { return a.re * a.re + a.im * a.im; }

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// IP sweep over both rows of one bin's W (w[n][c]); u holds the compact
// covariance entries [u00, u11, re u01, im u01], each for sources 0 and 1.
// Divisions are shared where their operands allow it without leaving the
// float32 range.
__device__ void ip_update_bin(cf w[2][2], const float u[8], float threshold) {
  for (int n = 0; n < 2; ++n) {
    const float u00 = u[n], u11 = u[2 + n];
    const cf u01 = make(u[4 + n], u[6 + n]), u10 = cconj(u01);
    cf WU[2][2];
    for (int s = 0; s < 2; ++s) {
      WU[s][0] = add(scale(w[s][0], u00), mul(w[s][1], u10));
      WU[s][1] = add(mul(w[s][0], u01), scale(w[s][1], u11));
    }
    const cf det = sub(mul(WU[0][0], WU[1][1]), mul(WU[0][1], WU[1][0]));
    // (W U)^{-1} = adj(W U) / det; the adjugate's entries are those of W U
    const float m00 = cmag(WU[0][0]), m01 = cmag(WU[0][1]);
    const float m10 = cmag(WU[1][0]), m11 = cmag(WU[1][1]);
    const float norm = fmaxf(m00 + m10, m01 + m11);
    const float inv_norm = fmaxf(m11 + m10, m01 + m00) / cmag(det);
    const bool ok = norm * inv_norm < threshold;  // false on NaN and on det = 0

    // w = column n of adj / det, det scaled by its larger component first so
    // that |det|^2 does not underflow; det = 0 gives NaN
    const cf adj[2] = {n == 0 ? WU[1][1] : neg(WU[0][1]), n == 0 ? neg(WU[1][0]) : WU[0][0]};
    const float sc = fmaxf(fabsf(det.re), fabsf(det.im));
    const float br = det.re / sc, bi = det.im / sc;
    const float d = (br * br + bi * bi) * sc;
    cf wn[2];
    for (int k = 0; k < 2; ++k)
      wn[k] = make((adj[k].re * br + adj[k].im * bi) / d, (adj[k].im * br - adj[k].re * bi) / d);

    // w^H U w = |L^H w|^2 with the closed-form 2x2 Cholesky factor L
    const float s0 = clamp0(u00);
    const float l00 = sqrtf(s0);
    const float r00 = 1.f / fmaxf(l00, 1e-32f);
    const cf l10 = s0 > 0.f ? scale(u10, r00) : make(0.f, 0.f);
    const float s1 = clamp0(u11 - abs2(l10));
    const float l11 = sqrtf(s1);
    const cf t0 = add(scale(wn[0], l00), mul(cconj(l10), wn[1]));
    const cf t1 = scale(wn[1], l11);
    const float r = 1.f / sqrtf(abs2(t0) + abs2(t1));
    if (ok) {
      w[n][0] = scale(cconj(wn[0]), r);
      w[n][1] = scale(cconj(wn[1]), r);
    }
  }
}

// ---- the cross-block reduction ---------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Every block of the grid waits here until all have arrived; their writes
// before it are visible to all after it.  count is 0 between barriers and
// gen counts them.  The grid is launched cooperatively, so all its blocks
// are resident and the wait ends.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned* gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = ld_acquire(gen);
    fence_acq_rel_gpu();  // release the block's writes
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      *count = 0;
      st_release(gen, g + 1);
    } else {
      while (ld_acquire(gen) == g) {
      }
    }
    fence_acq_rel_gpu();  // acquire the others'
  }
  __syncthreads();
}

// sum_{r0 <= r < r1} rows[r * stride] in row order, reads past L1 (the rows
// were written by other blocks), kBatch rows in flight at a time (a run is
// at most 33 rows at 2 blocks per SM on 132 SMs).
__device__ __forceinline__ float sum_rows(const float* rows, int r0, int r1, int stride) {
  constexpr int kBatch = 36;
  float s = 0.f;
  for (int r = r0; r < r1; r += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (r + k < r1) v[k] = __ldcg(rows + static_cast<size_t>(r + k) * stride);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (r + k < r1) s += v[k];
  }
  return s;
}

// floats per partial row: 2 T frame sums and the logdet, padded to 16 bytes
__host__ __device__ __forceinline__ int row_stride(int T) { return (2 * T + 1 + 3) / 4 * 4; }

__host__ __device__ __forceinline__ size_t weights_bytes(int T) {
  const size_t n = 8 * static_cast<size_t>(T < kChunk ? T : kChunk);
  return (n + 15) / 16 * 16;
}

// bytes of one channel's slab region: B rows of T complex64 and 16 bytes of
// slack for a start that is 8 bytes past a 16-byte boundary
__host__ __device__ __forceinline__ size_t slab_bytes(int bins, int T) {
  return 8 * static_cast<size_t>(bins) * T + 16;
}

// ---- the contrasts ------------------------------------------------------------

enum Contrast { kLaplace = 0, kGauss = 1 };

// 1/R for a frame whose power sum over the bins is p
template <int kContrast>
__device__ __forceinline__ float inverse_weight(float p, float bins, float eps) {
  return kContrast == kGauss ? 1.f / fmaxf(p / bins, eps) : 1.f / fmaxf(sqrtf(p), eps);
}

// one frame's term of the NLL's contrast sum, before the scale of nll_from
template <int kContrast>
__device__ __forceinline__ float contrast_term(float p, float bins, float eps) {
  return kContrast == kGauss ? logf(fmaxf(p / bins, eps)) : sqrtf(p);
}

template <int kContrast>
__device__ __forceinline__ float nll_from(float total, float logdet, float bins, int T) {
  const float scale = kContrast == kGauss ? bins : 2.f;
  return scale * total - 2.f * static_cast<float>(T) * logdet;
}

// ---- the kernel --------------------------------------------------------------

template <int B, bool kResident, int kContrast>
__global__ void __launch_bounds__(kThreads, 2)
fused_ip_kernel(const float2* __restrict__ x,      // (2, F, T)
                const float2* __restrict__ w_in,   // (2, 2, F)
                const float* __restrict__ psum_in, // (2, T)
                float2* __restrict__ w_out,        // (2, 2, F)
                float* __restrict__ part,          // rows, root sums, logdet
                unsigned* __restrict__ tickets,    // [barrier count, barrier gen, ticket]
                float* __restrict__ psum_out,      // (2, T)
                float* __restrict__ stats,         // [logdet, nll]
                int F, int T, int n_bins, float eps, float threshold) {
  static_assert(B == 2 || B == 4 || B == 8, "B must be 2, 4 or 8");
  constexpr int S = kWarps / B;  // warps per bin

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar_s[B / 2];  // one per pair of bins
  __shared__ float cov_s[B][S][8];
  __shared__ cf w_s[B][2][2];
  __shared__ float ld_s[B];
  __shared__ float red_s[kWarps];
  __shared__ float col_s[kWarps][32];
  __shared__ int flag_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float bins_f = static_cast<float>(n_bins);  // the Gauss contrast's F
  K2_STAMP(0);  // block started
  const int groups = (F + B - 1) / B;  // groups of B bins; this block takes every gridDim-th
  const int wstride = T < kChunk ? T : kChunk;
  float* winv_s = reinterpret_cast<float*>(smem);  // (2, wstride)
  const int stride = row_stride(T);
  float* row = part + static_cast<size_t>(blockIdx.x) * stride;
  float ld_block = 0.f;  // thread 0: sum of log|det W_f| over the block's bins

  if (kResident && tid < B / 2) {
    mbar_init(&bar_s[tid]);
    mbar_fence_init();
  }

  for (int grp = blockIdx.x, it = 0; grp < groups; grp += gridDim.x, ++it) {
    const int f0 = grp * B;
    const int nb = min(B, F - f0);
    const unsigned parity = it & 1;  // phase of this group's mbarriers

    // element (b, t) of channel c of the group's bins is xs[c][b * T + t]
    const float2* src[2] = {x + static_cast<size_t>(f0) * T,
                            x + (static_cast<size_t>(F) + f0) * T};
    const float2* xs[2] = {src[0], src[1]};
    if (kResident) {
      float2* slab[2];
      for (int c = 0; c < 2; ++c) {
        unsigned char* region = smem + weights_bytes(T) + c * slab_bytes(B, T);
        // same offset mod 16 as the source, so 16-byte runs map to 16-byte runs
        slab[c] = reinterpret_cast<float2*>(region + (reinterpret_cast<uintptr_t>(src[c]) & 15));
        xs[c] = slab[c];
      }
      if (tid < B / 2 && 2 * tid < nb) {  // lane g issues pair g
        const int g = tid;
        const int rows = min(2, nb - 2 * g);
        uintptr_t lo[2], hi[2];
        unsigned bytes = 0;
        for (int c = 0; c < 2; ++c) {
          const uintptr_t s = reinterpret_cast<uintptr_t>(src[c] + static_cast<size_t>(2 * g) * T);
          lo[c] = up16(s);
          hi[c] = down16(s + 8 * static_cast<uintptr_t>(rows) * T);
          if (hi[c] > lo[c]) bytes += static_cast<unsigned>(hi[c] - lo[c]);
        }
        mbar_expect(&bar_s[g], bytes);
        for (int c = 0; c < 2; ++c)
          if (hi[c] > lo[c])
            bulk_copy(reinterpret_cast<unsigned char*>(slab[c]) +
                          (lo[c] - reinterpret_cast<uintptr_t>(src[c])),
                      reinterpret_cast<const void*>(lo[c]), static_cast<unsigned>(hi[c] - lo[c]),
                      &bar_s[g]);
      }
      // warp 1: the 8-byte ends of each (channel, pair) run that are off 16
      // bytes; visible to all after the first barrier of the frame loop
      const int e = tid - 32;
      if (e >= 0 && e < 4 * (B / 2)) {
        const int c = e & 1, tail = (e >> 1) & 1, g = e >> 2;
        if (2 * g < nb) {
          const int rows = min(2, nb - 2 * g);
          const size_t first = static_cast<size_t>(2 * g) * T;
          const size_t end = first + static_cast<size_t>(rows) * T;
          const size_t i = tail ? end - 1 : first;
          const uintptr_t at = reinterpret_cast<uintptr_t>(src[c] + (tail ? end : first));
          if (at & 15) slab[c][i] = src[c][i];
        }
      }
    }
    // warps 2-3: the old rows, off the IP update's path
    {
      const int i = tid - 64;
      if (i >= 0 && i < 4 * nb) {
        const int b = i >> 2, nc = i & 3;
        const float2 v = w_in[nc * static_cast<size_t>(F) + f0 + b];
        w_s[b][nc >> 1][nc & 1] = make(v.x, v.y);
      }
    }

    // ---- covariance over frames: S warps per bin ----
    const int share = warp % S;
    const int cb = warp / S;  // this warp's bin
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;

    for (int t0 = 0; t0 < T; t0 += kChunk) {
      const int len = min(kChunk, T - t0);
      __syncthreads();  // the previous chunk's weights are consumed
      for (int j = tid; j < len; j += kThreads) {
        winv_s[j] = inverse_weight<kContrast>(psum_in[t0 + j], bins_f, eps);
        winv_s[wstride + j] = inverse_weight<kContrast>(psum_in[T + t0 + j], bins_f, eps);
      }
      __syncthreads();
      if (cb >= nb) continue;  // warp-uniform; the loop has no barrier past this
      if (kResident && t0 == 0) mbar_wait(&bar_s[cb / 2], parity);
      K2_STAMP(3);  // this warp's bins landed (resident) or next chunk staged
      const float2* r0 = xs[0] + static_cast<size_t>(cb) * T + t0;
      const float2* r1 = xs[1] + static_cast<size_t>(cb) * T + t0;
#pragma unroll 4
      for (int t = share * 32 + lane; t < len; t += 32 * S) {
        const float2 a = r0[t], c = r1[t];
        const float p00 = a.x * a.x + a.y * a.y;
        const float p11 = c.x * c.x + c.y * c.y;
        const float pre = a.x * c.x + a.y * c.y;
        const float pim = a.y * c.x - a.x * c.y;
        const float v0 = winv_s[t], v1 = winv_s[wstride + t];
        acc[0] += p00 * v0; acc[1] += p00 * v1;
        acc[2] += p11 * v0; acc[3] += p11 * v1;
        acc[4] += pre * v0; acc[5] += pre * v1;
        acc[6] += pim * v0; acc[7] += pim * v1;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 8; ++k) cov_s[cb][share][k] = acc[k];
    K2_STAMP(4);  // covariance reduced
    __syncthreads();

    // ---- IP update: one lane per bin, all bins at once ----
    if (tid < nb) {
      const int b = tid;
      const size_t f = static_cast<size_t>(f0) + b;
      const float inv_frames = 1.f / static_cast<float>(T);
      float u[8];
      for (int k = 0; k < 8; ++k) {
        float s = cov_s[b][0][k];
        for (int i = 1; i < S; ++i) s += cov_s[b][i][k];
        u[k] = s * inv_frames;
      }
      cf w[2][2] = {{w_s[b][0][0], w_s[b][0][1]}, {w_s[b][1][0], w_s[b][1][1]}};
      ip_update_bin(w, u, threshold);
      for (int n = 0; n < 2; ++n)
        for (int c = 0; c < 2; ++c) {
          w_s[b][n][c] = w[n][c];
          w_out[(n * 2 + c) * static_cast<size_t>(F) + f] = make_float2(w[n][c].re, w[n][c].im);
        }
      ld_s[b] = logf(cmag(sub(mul(w[0][0], w[1][1]), mul(w[0][1], w[1][0]))));
    }
    __syncthreads();
    K2_STAMP(5);  // IP update done

    // ---- the group's share of sum_f |W x|^2 per frame, into the block's row ----
    if (kResident)
      for (int g = 0; 2 * g < nb; ++g) mbar_wait(&bar_s[g], parity);  // slab visible here too
    // the new rows in registers; bins past nb read bin 0's frames with zero
    // rows, which add exactly 0
    cf ws[B][2][2];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) ws[b][n][c] = b < nb ? w_s[b][n][c] : make(0.f, 0.f);
    for (int t = tid; t < T; t += kThreads) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const size_t i = static_cast<size_t>(b < nb ? b : 0) * T + t;
        const float2 a = xs[0][i], c = xs[1][i];
        const cf xa = make(a.x, a.y), xc = make(c.x, c.y);
        s0 += abs2(add(mul(ws[b][0][0], xa), mul(ws[b][0][1], xc)));
        s1 += abs2(add(mul(ws[b][1][0], xa), mul(ws[b][1][1], xc)));
      }
      // the same thread owns frame t in every group, so no other writes it
      row[t] = it == 0 ? s0 : row[t] + s0;
      row[T + t] = it == 0 ? s1 : row[T + t] + s1;
    }
    if (tid == 0)
      for (int b = 0; b < nb; ++b) ld_block += ld_s[b];
    __syncthreads();  // the next group reuses the shared arrays
    if (kResident && tid < B / 2) fence_proxy_async();
  }
  if (tid == 0) row[2 * T] = ld_block;

  // ---- cross-block sums: every column over all rows, then the NLL ----
  K2_STAMP(6);  // partial row written
  grid_barrier(&tickets[0], &tickets[1]);
  K2_STAMP(7);  // grid barrier passed
  // A block takes 32 columns at a time, a lane each; warp w sums the w-th
  // run of rows in row order, and lane c of warp 0 adds the 8 runs in warp
  // order.  The runs depend only on the grid, so the bits do not change.
  const int rows_n = gridDim.x;
  const int run = (rows_n + kWarps - 1) / kWarps;
  const int r0 = min(warp * run, rows_n), r1 = min(r0 + run, rows_n);
  const int columns = 2 * T + 1;
  float* root_part = part + static_cast<size_t>(rows_n) * stride;  // (rows_n,)
  float* logdet_slot = root_part + rows_n;
  float root = 0.f;  // lanes of warp 0: contrast terms of this block's columns
  for (int q0 = 32 * blockIdx.x; q0 < columns; q0 += 32 * gridDim.x) {
    const int q = q0 + lane;
    col_s[warp][lane] = q < columns ? sum_rows(part + q, r0, r1, stride) : 0.f;
    __syncthreads();
    if (warp == 0 && q < columns) {
      float v = col_s[0][lane];
      for (int w = 1; w < kWarps; ++w) v += col_s[w][lane];
      if (q < 2 * T) {
        psum_out[q] = v;
        root += contrast_term<kContrast>(v, bins_f, eps);
      } else {
        *logdet_slot = v;
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) root += __shfl_xor_sync(0xffffffffu, root, off);
    if (lane == 0) root_part[blockIdx.x] = root;
  }
  K2_STAMP(8);  // columns summed
  if (!last_to_arrive(&tickets[2], gridDim.x, &flag_s)) return;
  // the last block sums the blocks' shares of the contrast sum: a thread per
  // block, then a fixed tree
  float v = 0.f;
  for (int i = tid; i < rows_n; i += kThreads) v += __ldcg(root_part + i);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red_s[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < kWarps; ++i) total += red_s[i];
    const float logdet = __ldcg(logdet_slot);
    stats[0] = logdet;
    stats[1] = nll_from<kContrast>(total, logdet, bins_f, T);
  }
  K2_STAMP(9);  // end (last block only)
}

// Blocks of fused_ip_kernel<B, kResident, kContrast> that fit on the device
// at once with `smem` bytes each, cached per device.
template <int B, bool kResident, int kContrast>
cudaError_t resident_blocks(int device, size_t smem, int* out) {
  static size_t cached_smem[kMaxDevices] = {};
  static int cached[kMaxDevices] = {};
  if (cached[device] == 0 || cached_smem[device] != smem) {
    auto kernel = fused_ip_kernel<B, kResident, kContrast>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm * sms < 1) return cudaErrorInvalidConfiguration;
    cached[device] = per_sm * sms;
    cached_smem[device] = smem;
  }
  *out = cached[device];
  return cudaSuccess;
}

template <int B, bool kResident, int kContrast>
cudaError_t launch(const void* x, const void* w_in, const void* psum_in, void* w_out,
                   void* psum_out, void* stats, void* part, void* tickets, int F, int T,
                   int n_bins, size_t smem, float eps, float threshold, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  int capacity = 0;
  err = resident_blocks<B, kResident, kContrast>(device, smem, &capacity);
  if (err != cudaSuccess) return err;
  const int groups = (F + B - 1) / B;
  const int blocks = groups < capacity ? groups : capacity;
  const float2* xp = static_cast<const float2*>(x);
  const float2* wp = static_cast<const float2*>(w_in);
  const float* pp = static_cast<const float*>(psum_in);
  float2* wo = static_cast<float2*>(w_out);
  float* pa = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float* po = static_cast<float*>(psum_out);
  float* st = static_cast<float*>(stats);
  void* args[] = {&xp, &wp, &pp, &wo, &pa, &tk, &po, &st, &F, &T, &n_bins, &eps, &threshold};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_ip_kernel<B, kResident, kContrast>),
                                    dim3(blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The layouts that ops/fused_ip.py::k2_launch_plan picks, for one contrast.
template <int kContrast>
cudaError_t launch_plan(const void* x, const void* w_in, const void* psum_in, void* w_out,
                        void* psum_out, void* stats, void* part, void* tickets, int F, int T,
                        int n_bins, int bins, bool resident, size_t smem, float eps, float threshold,
                        cudaStream_t s) {
  if (!resident && bins == 8)
    return launch<8, false, kContrast>(x, w_in, psum_in, w_out, psum_out, stats, part, tickets, F, T, n_bins, smem, eps, threshold, s);
  if (resident && bins == 8)
    return launch<8, true, kContrast>(x, w_in, psum_in, w_out, psum_out, stats, part, tickets, F, T, n_bins, smem, eps, threshold, s);
  if (resident && bins == 4)
    return launch<4, true, kContrast>(x, w_in, psum_in, w_out, psum_out, stats, part, tickets, F, T, n_bins, smem, eps, threshold, s);
  if (resident && bins == 2)
    return launch<2, true, kContrast>(x, w_in, psum_in, w_out, psum_out, stats, part, tickets, F, T, n_bins, smem, eps, threshold, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (2, F, T) complex64; w_in, w_out: (2, 2, F) complex64; psum_in,
// psum_out: (2, T) f32; stats: (2,) f32 = [logdet, nll]; part: scratch of
// ceil(F / bins) * (row_stride + 1) + 1 f32, row_stride = 4 ceil((2T + 1) /
// 4); tickets: 3 unsigned, zero before the first launch (the kernel leaves
// the counters zero).  bins, resident and smem_bytes come from
// ops/fused_ip.py::k2_launch_plan: a resident slab of 2, 4 or 8 bins, or
// the frame axis streamed in groups of 8.  contrast: 0 Laplace, 1 Gauss;
// n_bins: the Gauss contrast's bin count (F, or a bin-sharded caller's
// whole count).
// Returns the launch's cudaError_t (0 on success).
extern "C" int fused_auxiva_ip_f32(const void* x, const void* w_in, const void* psum_in,
                                   void* w_out, void* psum_out, void* stats, void* part,
                                   void* tickets, int F, int T, int n_bins, int bins, int resident,
                                   int smem_bytes, int contrast, float eps, float threshold,
                                   void* stream) {
  if (F < 1 || T < 1 || n_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = weights_bytes(T) + (resident ? 2 * slab_bytes(bins, T) : 0);
  if (static_cast<size_t>(smem_bytes) < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err = cudaErrorInvalidValue;
  if (contrast == kLaplace)
    err = launch_plan<kLaplace>(x, w_in, psum_in, w_out, psum_out, stats, part, tickets, F, T, n_bins, bins, resident != 0, smem, eps, threshold, s);
  else if (contrast == kGauss)
    err = launch_plan<kGauss>(x, w_in, psum_in, w_out, psum_out, stats, part, tickets, F, T, n_bins, bins, resident != 0, smem, eps, threshold, s);
  return static_cast<int>(err);
}

#ifdef K2_TIMELINE
// Copies the first n stamps (block b's stamp k at b * 16 + k, ns of
// %globaltimer, 0 where not stamped) to host memory at dst and clears them all.
extern "C" int k2_stamps(void* dst, int n) {
  void* stamps = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&stamps, g_stamps);
  if (err == cudaSuccess)
    err = cudaMemcpy(dst, stamps, n * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  if (err == cudaSuccess) err = cudaMemset(stamps, 0, sizeof(g_stamps));
  return static_cast<int>(err);
}
#endif

// One whole AuxIVA-IP iteration for C = N = 2 (kernel K2).
//
// Per bin f, from the previous iteration's frame power sums psum (2, T):
//   winv[n, t] = 1 / max(sqrt(psum[n, t]), eps)
//   U_n        = (1/T) sum_t winv[n, t] x x^H          (4 planes x 2 sources)
//   for n = 0, 1 (sequential rows):
//     w    = (W U_n)^{-1} e_n                          (2x2 adjugate)
//     keep the old row unless kappa_1(W U_n) < threshold
//     W[n] = conj(w) / sqrt(w^H U_n w)                 (Cholesky sum of squares)
// and then, for the next iteration and this iteration's loss,
//   psum'[n, t] = sum_f |sum_c W[n, c] x_c|^2,   logdet = sum_f log|det W_f|,
//   nll         = 2 sum sqrt(psum') - 2 T logdet.
// The estimates Y are never written to device memory.
//
// Replaces audio_source_separation_tpu/ops/pallas_fused.py::_iter_kernel
// (pallas_call in fused_auxiva_ip_iter).  Where the Pallas design does not
// carry over:
//  * Cross-tile sums.  The TPU kernel accumulates psum and logdet in one
//    block that every sequential grid step revisits.  Here each block writes
//    its partial sums and a second one-block kernel reduces them in a fixed
//    order, so the result is the same bits on every run (no float atomics).
//  * w^H U w uses the closed-form 2x2 Cholesky sum of squares of
//    ops/ip_components.py::cholesky_quadratic_components, which cannot go
//    negative in float32 (the Pallas body's direct sum can).
//  * eps and threshold are the solver's, passed by the wrapper.
//  * Ragged edges are masked in the kernel: no padded copies of X.
//  * An all-zero bin has a singular U, so det = 0 and the inverse is NaN;
//    the kappa_1 comparison is false on NaN and the old rows are kept, and
//    the bin adds |W x|^2 = 0 to psum.  This relies on IEEE NaN semantics:
//    never build with fast math.
//  * Shared memory: the Pallas tile (4, 128, 512) f32 does not fit a
//    Hopper block.  A block takes 16 bins; a warp reduces one bin's frame
//    sums at a time, and the separation phase re-reads the block's X slab,
//    which is still in the 50 MB L2 (all of X is 15.4 MB at 2x2049x469).
//
// Bound: X is read once from device memory, 8*2*F*T bytes; at F = 2049,
// T = 469 that is 15.4 MB, about 4.6 us at 3.35 TB/s, and the arithmetic
// (about 70 flops per (f, t)) is far below the card's float32 rate, so the
// bound is bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 16;
constexpr int kWarps = 8;
constexpr int kReduceThreads = 1024;

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
__device__ __forceinline__ cf rdiv(cf a, float s) { return {a.re / s, a.im / s}; }
__device__ __forceinline__ float cmag(cf a) { return hypotf(a.re, a.im); }
__device__ __forceinline__ float abs2(cf a) { return a.re * a.re + a.im * a.im; }

// a / b with b scaled by its larger component first, so that |b|^2 does not
// underflow for small well-conditioned determinants; b = 0 gives NaN.
__device__ __forceinline__ cf cdiv(cf a, cf b) {
  const float s = fmaxf(fabsf(b.re), fabsf(b.im));
  const float br = b.re / s, bi = b.im / s;
  const float d = (br * br + bi * bi) * s;
  return {(a.re * br + a.im * bi) / d, (a.im * br - a.re * bi) / d};
}

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// IP sweep over both rows of one bin's W (w[n][c]); u00/u11/ure/uim hold the
// compact covariance entries of U_0 and U_1.
__device__ void ip_update_bin(cf w[2][2], const float u00[2], const float u11[2],
                              const float ure[2], const float uim[2],
                              float threshold) {
  for (int n = 0; n < 2; ++n) {
    const cf U[2][2] = {{make(u00[n], 0.f), make(ure[n], uim[n])},
                        {make(ure[n], -uim[n]), make(u11[n], 0.f)}};
    cf WU[2][2];
    for (int s = 0; s < 2; ++s)
      for (int j = 0; j < 2; ++j)
        WU[s][j] = add(mul(w[s][0], U[0][j]), mul(w[s][1], U[1][j]));
    const cf det = sub(mul(WU[0][0], WU[1][1]), mul(WU[0][1], WU[1][0]));
    const cf inv[2][2] = {{cdiv(WU[1][1], det), cdiv(neg(WU[0][1]), det)},
                          {cdiv(neg(WU[1][0]), det), cdiv(WU[0][0], det)}};
    const cf wn[2] = {inv[0][n], inv[1][n]};

    const float norm = fmaxf(cmag(WU[0][0]) + cmag(WU[1][0]),
                             cmag(WU[0][1]) + cmag(WU[1][1]));
    const float inv_norm = fmaxf(cmag(inv[0][0]) + cmag(inv[1][0]),
                                 cmag(inv[0][1]) + cmag(inv[1][1]));
    const bool ok = norm * inv_norm < threshold;  // false on NaN

    // w^H U w = |L^H w|^2 with the closed-form 2x2 Cholesky factor L
    const float s0 = clamp0(U[0][0].re);
    const float l00 = sqrtf(s0);
    const float d_safe = fmaxf(l00, 1e-32f);
    const cf l10 = s0 > 0.f ? rdiv(U[1][0], d_safe) : make(0.f, 0.f);
    const float s1 = clamp0(U[1][1].re - abs2(l10));
    const float l11 = sqrtf(s1);
    const cf t0 = add(scale(wn[0], l00), mul(cconj(l10), wn[1]));
    const cf t1 = scale(wn[1], l11);
    const float denom = sqrtf(abs2(t0) + abs2(t1));
    if (ok) {
      w[n][0] = rdiv(cconj(wn[0]), denom);
      w[n][1] = rdiv(cconj(wn[1]), denom);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
fused_ip_kernel(const float2* __restrict__ x,        // (2, F, T)
                const float2* __restrict__ w_in,     // (2, 2, F)
                const float* __restrict__ psum_in,   // (2, T)
                float2* __restrict__ w_out,          // (2, 2, F)
                float* __restrict__ psum_part,       // (blocks, 2, T)
                float* __restrict__ logdet_part,     // (blocks,)
                int F, int T, float eps, float threshold) {
  extern __shared__ float winv_s[];  // (2, T)
  __shared__ cf w_s[kBins][2][2];
  __shared__ float ld_s[kBins];

  for (int i = threadIdx.x; i < 2 * T; i += blockDim.x)
    winv_s[i] = 1.f / fmaxf(sqrtf(psum_in[i]), eps);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.x * kBins;
  const int nb = min(kBins, F - f0);
  const float n_frames = static_cast<float>(T);

  // phase 1: covariance over frames, then the IP update, one bin per warp
  for (int b = warp; b < nb; b += kWarps) {
    const int f = f0 + b;
    const float2* x0 = x + static_cast<size_t>(f) * T;
    const float2* x1 = x + (static_cast<size_t>(F) + f) * T;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = lane; t < T; t += 32) {
      const float2 a = x0[t], c = x1[t];
      const float p00 = a.x * a.x + a.y * a.y;
      const float p11 = c.x * c.x + c.y * c.y;
      const float pre = a.x * c.x + a.y * c.y;
      const float pim = a.y * c.x - a.x * c.y;
      const float v0 = winv_s[t], v1 = winv_s[T + t];
      acc[0] += p00 * v0; acc[1] += p00 * v1;
      acc[2] += p11 * v0; acc[3] += p11 * v1;
      acc[4] += pre * v0; acc[5] += pre * v1;
      acc[6] += pim * v0; acc[7] += pim * v1;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);

    if (lane == 0) {
      const float u00[2] = {acc[0] / n_frames, acc[1] / n_frames};
      const float u11[2] = {acc[2] / n_frames, acc[3] / n_frames};
      const float ure[2] = {acc[4] / n_frames, acc[5] / n_frames};
      const float uim[2] = {acc[6] / n_frames, acc[7] / n_frames};
      cf w[2][2];
      for (int n = 0; n < 2; ++n)
        for (int c = 0; c < 2; ++c) {
          const float2 v = w_in[(n * 2 + c) * static_cast<size_t>(F) + f];
          w[n][c] = make(v.x, v.y);
        }
      ip_update_bin(w, u00, u11, ure, uim, threshold);
      for (int n = 0; n < 2; ++n)
        for (int c = 0; c < 2; ++c) {
          w_s[b][n][c] = w[n][c];
          w_out[(n * 2 + c) * static_cast<size_t>(F) + f] =
              make_float2(w[n][c].re, w[n][c].im);
        }
      const cf det = sub(mul(w[0][0], w[1][1]), mul(w[0][1], w[1][0]));
      ld_s[b] = logf(cmag(det));
    }
  }
  __syncthreads();

  // phase 2: this block's share of sum_f |y|^2 per frame, from the new W
  float* part = psum_part + static_cast<size_t>(blockIdx.x) * 2 * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float s0 = 0.f, s1 = 0.f;
    for (int b = 0; b < nb; ++b) {
      const int f = f0 + b;
      const float2 a = x[static_cast<size_t>(f) * T + t];
      const float2 c = x[(static_cast<size_t>(F) + f) * T + t];
      const cf xa = make(a.x, a.y), xc = make(c.x, c.y);
      s0 += abs2(add(mul(w_s[b][0][0], xa), mul(w_s[b][0][1], xc)));
      s1 += abs2(add(mul(w_s[b][1][0], xa), mul(w_s[b][1][1], xc)));
    }
    part[t] = s0;
    part[T + t] = s1;
  }
  if (threadIdx.x == 0) {
    float ld = 0.f;
    for (int b = 0; b < nb; ++b) ld += ld_s[b];
    logdet_part[blockIdx.x] = ld;
  }
}

// Second pass: fixed-order reduction of the per-block partials.
__global__ void __launch_bounds__(kReduceThreads)
fused_ip_reduce(const float* __restrict__ psum_part,
                const float* __restrict__ logdet_part, int blocks, int T,
                float* __restrict__ psum_out,  // (2, T)
                float* __restrict__ stats) {   // [logdet, nll]
  __shared__ float red[kReduceThreads];
  float root_sum = 0.f;
  for (int i = threadIdx.x; i < 2 * T; i += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int b = 0; b < blocks; ++b) s += psum_part[static_cast<size_t>(b) * 2 * T + i];
    psum_out[i] = s;
    root_sum += sqrtf(s);
  }
  red[threadIdx.x] = root_sum;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float ld = 0.f;
    for (int b = 0; b < blocks; ++b) ld += logdet_part[b];
    stats[0] = ld;
    stats[1] = 2.f * red[0] - 2.f * static_cast<float>(T) * ld;
  }
}

}  // namespace

extern "C" int fused_auxiva_ip_bins_per_block() { return kBins; }

// x: (2, F, T) complex64; w_in, w_out: (2, 2, F) complex64; psum_in,
// psum_out: (2, T) f32; psum_part: (blocks, 2, T) f32; logdet_part:
// (blocks,) f32; stats: (2,) f32 = [logdet, nll].  blocks = ceil(F / 16).
// Returns the launches' cudaError_t (0 on success).
extern "C" int fused_auxiva_ip_f32(const void* x, const void* w_in,
                                   const void* psum_in, void* w_out,
                                   void* psum_part, void* logdet_part,
                                   void* psum_out, void* stats, int F, int T,
                                   float eps, float threshold, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (F + kBins - 1) / kBins;
  const size_t smem = sizeof(float) * 2 * T;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  fused_ip_kernel<<<blocks, kWarps * 32, smem, s>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(w_in),
      static_cast<const float*>(psum_in), static_cast<float2*>(w_out),
      static_cast<float*>(psum_part), static_cast<float*>(logdet_part), F, T,
      eps, threshold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ip_reduce<<<1, kReduceThreads, 0, s>>>(
      static_cast<const float*>(psum_part),
      static_cast<const float*>(logdet_part), blocks, T,
      static_cast<float*>(psum_out), static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

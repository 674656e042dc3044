// Weighted spatial covariance in compact Hermitian planes (kernel K1).
//
//   out[p, f, n] = (1/T) sum_t w[n, t] * plane_p(x[:, f, t])
//
// where plane_p runs over the C^2 compact pair products of
// ops/ip_components.py::_plane_index: C diagonal planes |x_c|^2, then for
// each c < d the (re, im) pair of x_c conj(x_d).
//
// Replaces audio_source_separation_tpu/ops/pallas_kernels.py::_cov_kernel
// (pallas_call in _weighted_covariance_pallas).  Unlike the TPU kernel it
// emits the compact (C^2, F, N) layout that the component IP update
// consumes, not (N, F, C, C).
//
// Bound: the kernel reads X once, 8*C*F*T bytes (complex64), plus the
// (N, T) weights, and writes C^2*F*N floats.  At C = 3, F = 2049, T = 469
// that is 23.1 MB, about 6.9 us at the H100's 3.35 TB/s; it is bound by
// bytes.  Design: one warp per bin, lanes stride the frame axis, so every
// element of X is read exactly once with coalesced 8-byte loads; the pair
// products are formed in registers and contracted against the weights in
// registers, then reduced across the warp by shuffles.  Pair products never
// reach device memory.  The weights are staged in shared memory kChunk
// frames at a time, so any T fits in N * min(T, kChunk) * 4 bytes (at most
// 32 KB, under the 48 KB a launch gets without opting in);
// kChunk is a multiple of 32, so each lane visits its frames in the same
// order as with all T staged at once.
//
// Any other C >= 1 and N >= 1 (the TPU kernel loops over any n_channels
// and n_sources) takes weighted_covariance_any_kernel: one warp per (bin,
// channel pair c <= d, tile of up to kTileN weight rows), lanes striding the
// frame axis in the same order, the pair's two rows of X and the weights
// read straight from global memory.  A row of X is read by every pair that
// holds its channel, mostly from L2; the specialised instances above stay
// the path of C in {2, 3, 4} with N <= 4.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 2048;  // frames of weights staged per pass

template <int C, int N>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
weighted_covariance_kernel(const float2* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ out, int F, int T) {
  extern __shared__ float w_s[];  // (N, stride), stride = min(T, kChunk)
  const int stride = min(T, kChunk);
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const bool active = f < F;  // idle warps still take part in the barriers

  constexpr int P = C * C;
  float acc[P][N];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[p][n] = 0.f;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int len = min(kChunk, T - t0);
    __syncthreads();  // the previous chunk's weights are consumed
    for (int n = 0; n < N; ++n)
      for (int j = threadIdx.x; j < len; j += blockDim.x)
        w_s[n * stride + j] = w[static_cast<size_t>(n) * T + t0 + j];
    __syncthreads();
    if (!active) continue;
    for (int t = lane; t < len; t += 32) {
      float2 xv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) xv[c] = x[(static_cast<size_t>(c) * F + f) * T + t0 + t];
      float pl[P];
      int k = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) pl[k++] = xv[c].x * xv[c].x + xv[c].y * xv[c].y;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = c + 1; d < C; ++d) {
          pl[k++] = xv[c].x * xv[d].x + xv[c].y * xv[d].y;
          pl[k++] = xv[c].y * xv[d].x - xv[c].x * xv[d].y;
        }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float wn = w_s[n * stride + t];
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p][n] += pl[p] * wn;
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[p][n] += __shfl_xor_sync(0xffffffffu, acc[p][n], off);

  if (lane == 0) {
    const float n_frames = static_cast<float>(T);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int n = 0; n < N; ++n)
        out[(static_cast<size_t>(p) * F + f) * N + n] = acc[p][n] / n_frames;
  }
}

constexpr int kTileN = 8;  // weight rows per warp in the any-C kernel

// out[p, f, n] for one (f, pair q, tile of weight rows) per warp.  Pair q < C
// is the diagonal (q, q), plane q; pair q >= C is the (q - C)-th c < d pair in
// _plane_index order, planes C + 2 (q - C) (re) and C + 2 (q - C) + 1 (im).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
weighted_covariance_any_kernel(const float2* __restrict__ x,
                               const float* __restrict__ w,
                               float* __restrict__ out, int C, int N, int F,
                               int T) {
  const int n_pairs = C * (C + 1) / 2;
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const long long item =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(F) * n_pairs * n_tiles) return;  // no barriers below
  const int lane = threadIdx.x & 31;
  // item = (f * n_pairs + q) * n_tiles + tile: a block's warps share bins
  const int tile = static_cast<int>(item % n_tiles);
  const int q = static_cast<int>((item / n_tiles) % n_pairs);
  const int f = static_cast<int>(item / (static_cast<long long>(n_tiles) * n_pairs));
  int c = q, d = q;
  if (q >= C) {
    int r = q - C;
    c = 0;
    while (r >= C - 1 - c) r -= C - 1 - (c++);
    d = c + 1 + r;
  }
  const int n0 = tile * kTileN;
  const int nt = min(kTileN, N - n0);
  const float2* xc = x + (static_cast<size_t>(c) * F + f) * T;
  const float2* xd = x + (static_cast<size_t>(d) * F + f) * T;
  const float* wt = w + static_cast<size_t>(n0) * T;

  float re[kTileN], im[kTileN];
#pragma unroll
  for (int k = 0; k < kTileN; ++k) re[k] = im[k] = 0.f;
#pragma unroll 4  // four frames' loads in flight per lane
  for (int t = lane; t < T; t += 32) {
    const float2 a = xc[t], b = xd[t];
    const float pr = a.x * b.x + a.y * b.y;  // |x_c|^2 when c == d
    const float pi = a.y * b.x - a.x * b.y;
#pragma unroll
    for (int k = 0; k < kTileN; ++k) {
      if (k < nt) {
        const float wk = wt[static_cast<size_t>(k) * T + t];
        re[k] += pr * wk;
        im[k] += pi * wk;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kTileN; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      re[k] += __shfl_xor_sync(0xffffffffu, re[k], off);
      im[k] += __shfl_xor_sync(0xffffffffu, im[k], off);
    }

  if (lane == 0) {
    const float n_frames = static_cast<float>(T);
    const int p = q < C ? q : C + 2 * (q - C);
#pragma unroll
    for (int k = 0; k < kTileN; ++k) {
      if (k < nt) {
        out[(static_cast<size_t>(p) * F + f) * N + n0 + k] = re[k] / n_frames;
        if (q >= C) out[(static_cast<size_t>(p + 1) * F + f) * N + n0 + k] = im[k] / n_frames;
      }
    }
  }
}

cudaError_t launch_any(const void* x, const void* w, void* out, int C, int N,
                       int F, int T, cudaStream_t stream) {
  const long long items =
      static_cast<long long>(F) * (C * (C + 1) / 2) * ((N + kTileN - 1) / kTileN);
  const long long blocks = (items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  weighted_covariance_any_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const float2*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), C, N, F, T);
  return cudaGetLastError();
}

template <int C, int N>
cudaError_t launch(const void* x, const void* w, void* out, int F, int T,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * N * (T < kChunk ? T : kChunk);  // <= 32 KB
  const int blocks = (F + kWarpsPerBlock - 1) / kWarpsPerBlock;
  weighted_covariance_kernel<C, N><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const float2*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), F, T);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(const void* x, const void* w, void* out, int N, int F,
                     int T, cudaStream_t stream) {
  switch (N) {
    case 1: return launch<C, 1>(x, w, out, F, T, stream);
    case 2: return launch<C, 2>(x, w, out, F, T, stream);
    case 3: return launch<C, 3>(x, w, out, F, T, stream);
    case 4: return launch<C, 4>(x, w, out, F, T, stream);
    default: return launch_any(x, w, out, C, N, F, T, stream);
  }
}

}  // namespace

// x: (C, F, T) complex64 viewed as float2; w: (N, T) f32; out: (C^2, F, N) f32;
// any C >= 1 and N >= 1.
// Returns the launch's cudaError_t (0 on success).
extern "C" int weighted_covariance_f32(const void* x, const void* w, void* out,
                                       int C, int N, int F, int T,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 2: return static_cast<int>(launch_c<2>(x, w, out, N, F, T, s));
    case 3: return static_cast<int>(launch_c<3>(x, w, out, N, F, T, s));
    case 4: return static_cast<int>(launch_c<4>(x, w, out, N, F, T, s));
    default:
      if (C < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_any(x, w, out, C, N, F, T, s));
  }
}

// FastMNMF's multiplicative-update sweeps with the model formed in registers
// (kernel K5).
//
// The operands (ops/mnmf_mu.py gives their layouts): x = |Q x|^2 (M, F, T),
// the basis W (S, F, K), the gains g (S, F, M) and the activations
// H (S, K, T), all real and contiguous.  With j = s K + k the joint
// (source, basis) index and J = S K, the model is
//
//   R[m, f, t] = max(sum_j Wg[m, f, j] H[j, t], eps),  Wg[m, f, j] = W[s, f, k] g[s, f, m],
//
// the product Wg rounded first, as the plain version's GEMM forms it.  R and
// its ratios x / R^2 and 1 / R are never written: every entry forms them
// frame by frame in registers and writes only what it is asked for.
//
//   * weights: 1 / R (M, F, T), for K1's per-bin covariances;
//   * frame statistics: E_num = sum_t x / R^2 H and E_den = sum_t H / R,
//     (M, F, S, K) each; fused, the basis update W sqrt(sum_m g E_num /
//     max(sum_m g E_den, eps)) or the gain update g sqrt(sum_k W E_num /
//     max(sum_k W E_den, eps)) from them in the same launch;
//   * bin statistics: sum_{m,f} x / R^2 Wg and sum_{m,f} Wg / R, (S, K, T)
//     each; fused, the activation update H sqrt(num / max(den, eps));
//   * fit: sum (x + eps) / (R' + eps) + log(R' + eps), R' the model before
//     the floor, as the NLL takes it.
//
// No Pallas kernel stands behind it: XLA fuses these chains in the JAX
// package's jitted step.  In PyTorch each entry is a GEMM for R, its floor,
// the ratios and one or two contractions (the bin contraction copying both
// ratio tensors to (F, M, T) first): some thirty passes over the 7.7 MB
// model an iteration at 2 x 2049 x 470, and about sixty launches.
//
// Bound: about 0.24 GFLOP an iteration and the 7.7 MB of x read by each of
// four entries (ops/mnmf_mu.py::k5_cost), 2.4-3.5 us an entry on the card.
// The entries are reductions whose operands are shared along one axis, so
// what bounds them is latency and the traffic between the cache and the
// threads, not arithmetic: the design brings each value in once and uses it
// many times, and forms the model again in every entry (S K fused
// multiply-adds a (channel, bin, frame), cheaper than writing it and
// reading it back).
//
// Design.  The joint axis J is bounded at compile time by kJ = kMaxJ = 24
// (the cell's S K is 20), so that every per-j array lives in registers;
// entries past J read as zero.  M <= 4 and S <= 4 (ops/mnmf_mu.py::MAX_M,
// MAX_S).  kMaxJ is what the statistics keep in registers: Wg (or H), the
// frame's H (or Wg) and the two sums, 4 kJ values a thread, 96 at float32
// within the 128 registers their blocks leave a thread; at kJ = 48 they
// spill, and the statistics read 2-2.3 times the plain version's time at
// S K = 30 (C = 3, K = 10), so the model takes the plain version past 24.
// At float64 the registers already spill at 24: the entries are right but
// the statistics slower than the plain version (no FastMNMF call on the
// card reaches them: K1 takes complex64 only).  Every
// quotient is a correctly rounded reciprocal (x / R^2 as x (1/R)^2).
//
//   * weights and fit: a block of kRowThreads frames and row_bins<T>()
//     bins, the bins' Wg staged once in shared memory, H[:, t] in each
//     thread's registers, four bins' sums in flight at a time.  The fit's
//     sums go through the block in a fixed tree, one partial a block, and
//     the last block to take the ticket adds the partials in block order;
//     its accumulators are doubles.
//   * frame statistics: a block per (group of 32 / M bins, span of frames),
//     a lane per (bin, channel) row with its Wg row and its 2 J sums in
//     registers, a warp per segment of the span; the span's H and the rows'
//     x staged in shared memory once, H read by all 32 lanes at once; the
//     warps' sums added in warp order, and across spans through scratch
//     after a ticket.  The fused update finds every channel of its bins in
//     the block.
//   * bin statistics: a block per (32-frame tile, chunk of bins), a lane per
//     frame with H[:, t] in registers; the chunk's W, g and x brought in by
//     asynchronous copies in one round, each warp forming its bins' Wg and
//     sweeping them; the warps' sums added in warp order; each block writes
//     its chunk's partial to scratch, and the last block of each tile to
//     take the ticket adds the chunks' partials in chunk order and applies
//     the update or writes the sums.  The chunks are as many as keep one
//     wave of blocks, and as few bins each as fit kBinSmem.
//
// No float atomics: every launch gives the same bits.  The tickets are left
// at zero.  Every floor is torch.clamp's (NaN passes).

#include <cuda_runtime.h>

#include <cmath>

#include "hopper_async.cuh"

namespace {

constexpr int kMaxM = 4;         // ops/mnmf_mu.py::MAX_M
constexpr int kMaxS = 4;         // ops/mnmf_mu.py::MAX_S
constexpr int kMaxJ = 24;        // ops/mnmf_mu.py::MAX_J (the note above)
constexpr int kRowThreads = 128; // weights, fit: frames a block (ops/mnmf_mu.py::ROW_THREADS)
constexpr int kFrameWarps = 16;  // frame statistics: warps a block, a segment of frames each
constexpr int kReduceWarps = 8;  // frame statistics: warps whose sums are added at a time
constexpr int kMaxDevices = 64;
constexpr int kBinWarps = 8;     // bin statistics: warps a block
constexpr int kTile = 32;        // bin statistics: frames a block (ops/mnmf_mu.py::TILE)
constexpr size_t kBinSmem = 100 * 1024;  // bin statistics: shared memory a block at most (ops/mnmf_mu.py::BIN_SMEM)

// weights, fit: bins a block (ops/mnmf_mu.py::ROW_BINS)
template <typename T>
__host__ __device__ constexpr int row_bins() {
  return sizeof(T) == 4 ? 16 : 8;
}

// torch.clamp(x, min=lo): NaN passes
template <typename T>
__device__ __forceinline__ T floor_below(T x, T lo) {
  return x < lo ? lo : x;
}

// the offsets of W[s, 0, k] and g[s, 0, 0] for each j < J, so that no thread
// divides by K again
__device__ __forceinline__ void joint_offsets(int* woff, int* goff, int kJ, int M, int S, int K, int F) {
  for (int j = threadIdx.x; j < kJ; j += blockDim.x) {
    const int s = j < S * K ? j / K : 0;
    woff[j] = s * F * K + (j - s * K);
    goff[j] = s * F * M;
  }
}

// Wg of bins f0 .. f0 + nb - 1 (nb <= kBins), [b][kMaxM][kJ] with zeros
// past M and J, by the kThreads threads of a group (idx: the thread's
// place in it); every load is issued before the first store, so that the
// group waits for the cache once
template <typename T, int kJ, int kBins, int kThreads>
__device__ __forceinline__ void stage_wg(T* wg, const T* __restrict__ w, const T* __restrict__ g, const int* woff,
                                         const int* goff, int f0, int nb, int M, int K, int J, int idx) {
  constexpr int kN = kBins * kMaxM * kJ;
  constexpr int kPer = (kN + kThreads - 1) / kThreads;
  T v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = idx + r * kThreads;
    const int j = i % kJ, q = i / kJ, m = q % kMaxM, b = q / kMaxM;
    const int f = f0 + b;
    v[r] = (i < kN && b < nb && m < M && j < J) ? w[woff[j] + f * K] * g[goff[j] + f * M + m] : T(0);
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = idx + r * kThreads;
    if (i < kN) wg[i] = v[r];
  }
}

// an asynchronous copy of one element into shared memory, zero where not
// valid (no byte read then)
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(hopper::smem_addr(dst)), "l"(src),
               "n"(sizeof(T)), "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// a product and a sum each rounded, never contracted into one fused
// multiply-add: the fused updates' sums over channels and bases, so that
// they give the bits of the same sums taken by separate PyTorch operations
// on a mesh's whole statistics (ops/mnmf_mu.py::_ordered_update)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// 1 / x, correctly rounded as the division is, in fewer instructions
__device__ __forceinline__ float reciprocal(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double reciprocal(double x) { return __drcp_rn(x); }

// kJ values from 16-byte aligned shared memory, in 16-byte loads
template <typename T, int kJ>
__device__ __forceinline__ void load_row(T (&v)[kJ], const T* p) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < kJ; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kJ; j += 2) {
      const double2 q = *reinterpret_cast<const double2*>(p + j);
      v[j] = q.x;
      v[j + 1] = q.y;
    }
  }
}

// H[:, t] (zero past J, or for a frame past the end)
template <typename T, int kJ>
__device__ __forceinline__ void load_h(T (&hv)[kJ], const T* __restrict__ h, int J, int nT, int t, bool live) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) hv[j] = (live && j < J) ? h[static_cast<long long>(j) * nT + t] : T(0);
}

template <typename T, int kJ>
__device__ __forceinline__ T dot(const T (&a)[kJ], const T (&b)[kJ]) {
  T r = T(0);
#pragma unroll
  for (int j = 0; j < kJ; ++j) r += a[j] * b[j];
  return r;
}

// ------------------------------------------------------- weights and fit

// A block: kRowThreads frames of row_bins<T>() bins, the bins' Wg staged in
// shared memory, H[:, t] in each thread's registers, the fit's x brought
// by asynchronous copies meanwhile.  kFit: the fit's sum
// (out: the scalar; part: one double a block; ticket: one), else the
// weights (out: (M, F, T)).
template <typename T, int kJ, bool kFit>
__global__ void __launch_bounds__(kRowThreads) row_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                                          const T* __restrict__ g, const T* __restrict__ h,
                                                          T* __restrict__ out, double* __restrict__ part,
                                                          unsigned* __restrict__ ticket, int M, int S, int K, int F,
                                                          int nT, T eps) {
  constexpr int kBins = row_bins<T>();
  static_assert(kBins % 4 == 0, "the sweep takes four bins at a time");
  __shared__ __align__(16) T wg_s[kBins * kMaxM * kJ];
  __shared__ T xs_s[kFit ? kBins * kMaxM * kRowThreads : 1];  // the fit's x, [b][m][frame]
  __shared__ int woff_s[kJ], goff_s[kJ];
  __shared__ double red_s[kRowThreads];
  __shared__ int flag_s;
  const int tid = threadIdx.x, J = S * K;
  const int t = blockIdx.x * kRowThreads + tid;
  const bool live = t < nT;
  const int f0 = blockIdx.y * kBins, nb = min(kBins, F - f0);
  if constexpr (kFit) {
#pragma unroll
    for (int q = 0; q < kBins * kMaxM; ++q) {
      const int b = q / kMaxM, m = q % kMaxM;
      const bool ok = live && b < nb && m < M;
      copy_async(&xs_s[q * kRowThreads + tid], ok ? x + (static_cast<long long>(m) * F + f0 + b) * nT + t : x, ok);
    }
    copy_async_commit();
  }
  joint_offsets(woff_s, goff_s, kJ, M, S, K, F);
  __syncthreads();
  stage_wg<T, kJ, kBins, kRowThreads>(wg_s, w, g, woff_s, goff_s, f0, nb, M, K, J, tid);
  T hv[kJ];
  load_h<T, kJ>(hv, h, J, nT, t, live);
  if constexpr (kFit) copy_async_wait<0>();
  __syncthreads();
  // four bins at a time, so that four independent sums are in flight; the
  // rows past nb are zero
  double acc = 0.0;
  if (live) {
    for (int m = 0; m < M; ++m) {
      for (int b0 = 0; b0 < nb; b0 += 4) {
        T r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          T wv[kJ];
          load_row<T, kJ>(wv, wg_s + ((b0 + u) * kMaxM + m) * kJ);
          r[u] = dot<T, kJ>(wv, hv);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int b = b0 + u;
          if (b < nb) {
            if constexpr (kFit) {
              const T y = r[u] + eps;
              acc += static_cast<double>((xs_s[(b * kMaxM + m) * kRowThreads + tid] + eps) * reciprocal(y) + log(y));
            } else {
              out[(static_cast<long long>(m) * F + f0 + b) * nT + t] = reciprocal(floor_below(r[u], eps));
            }
          }
        }
      }
    }
  }
  if constexpr (kFit) {
    red_s[tid] = acc;
    __syncthreads();
    for (int half = kRowThreads / 2; half > 0; half /= 2) {
      if (tid < half) red_s[tid] += red_s[tid + half];
      __syncthreads();
    }
    const unsigned blocks = gridDim.x * gridDim.y;
    if (tid == 0) part[blockIdx.y * gridDim.x + blockIdx.x] = red_s[0];
    if (!hopper::last_to_arrive(ticket, blocks, &flag_s)) return;
    double v = 0.0;
    for (unsigned b = tid; b < blocks; b += kRowThreads) v += __ldcg(part + b);
    red_s[tid] = v;
    __syncthreads();
    for (int half = kRowThreads / 2; half > 0; half /= 2) {
      if (tid < half) red_s[tid] += red_s[tid + half];
      __syncthreads();
    }
    if (tid == 0) out[0] = static_cast<T>(red_s[0]);
  }
}

// -------------------------------------------------------- frame statistics

// frame statistics: frames a warp, and a block's span of frames
template <typename T>
__host__ __device__ constexpr int frame_segment() {
  return sizeof(T) == 4 ? 32 : 16;
}

template <typename T, int kJ>
__host__ __device__ constexpr int frame_stage_bytes() {
  constexpr int kSpan = kFrameWarps * frame_segment<T>();
  return (kSpan * (kJ + 4) + 32 * (kSpan + 1)) * static_cast<int>(sizeof(T));
}

template <typename T, int kJ>
__host__ __device__ constexpr int frame_smem_bytes() {
  constexpr int kReduce = (kReduceWarps + 2) * kJ * 32 * static_cast<int>(sizeof(T));
  return frame_stage_bytes<T, kJ>() > kReduce ? frame_stage_bytes<T, kJ>() : kReduce;
}

// A block per (group of 32 / M bins, span of frames): a lane per (bin,
// channel) row with its Wg row and its 2 J sums in registers, a warp per
// segment of the span.  The span's H (transposed, a row of kJ + 4 a frame,
// read by all lanes at once) and the rows' x (a row of kSpan + 1 a (bin,
// channel), so that the 32 lanes fall in distinct banks) are staged in
// shared memory once; the warps' sums are then added in warp order through
// the same memory.  Where the frames take more than one span, each block
// writes its rows' sums to scratch (part: (groups, spans, 2 kJ, 32)) and
// the last block of the group to take its ticket adds the spans' in span
// order.  mode: 0 writes E_num, E_den (M, F, S, K); 1 the new basis
// (S, F, K); 2 the new gains (S, F, M)
template <typename T, int kJ>
__global__ void __launch_bounds__(kFrameWarps * 32, 1) frame_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g, const T* __restrict__ h,
    T* __restrict__ out0, T* __restrict__ out1, T* __restrict__ part, unsigned* __restrict__ tickets, int mode, int M,
    int S, int K, int F, int nT, T eps) {
  constexpr int kThreads = kFrameWarps * 32;
  constexpr int kSegment = frame_segment<T>();
  constexpr int kSpan = kFrameWarps * kSegment;
  constexpr int kStride = kJ + 4;
  constexpr int kXStride = kSpan + 1;
  extern __shared__ __align__(16) unsigned char dyn_s[];
  T* hs = reinterpret_cast<T*>(dyn_s);  // [kSpan][kStride]
  T* xs = hs + kSpan * kStride;         // [32][kXStride]
  T* red = reinterpret_cast<T*>(dyn_s); // after the sweep: [warp][kJ][32], then the sums [2 kJ][32]
  __shared__ int woff_s[kJ], goff_s[kJ];
  __shared__ long long xoff_s[32];
  __shared__ int flag_s;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int J = S * K;
  const int bins = 32 / M, rows = bins * M;
  const int f_base = blockIdx.y * bins;
  const int fb = lane / M, m = lane % M, f = f_base + fb;
  const bool live = lane < rows && f < F;
  const int t_base = blockIdx.x * kSpan, span = min(kSpan, nT - t_base);
  joint_offsets(woff_s, goff_s, kJ, M, S, K, F);
  if (tid < 32) xoff_s[tid] = live ? (static_cast<long long>(m) * F + f) * nT + t_base : -1;
  __syncthreads();
  {
    T v[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) v[j] = (j < J && tid < span) ? h[static_cast<long long>(j) * nT + t_base + tid] : T(0);
    T u[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const long long o = xoff_s[r];
      u[r] = (o >= 0 && tid < span) ? x[o + tid] : T(0);
    }
    if (tid < kSpan) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) hs[tid * kStride + j] = v[j];
#pragma unroll
      for (int r = 0; r < 32; ++r) xs[r * kXStride + tid] = u[r];
    }
  }
  T wg[kJ], an[kJ], ad[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    wg[j] = (live && j < J) ? w[woff_s[j] + f * K] * g[goff_s[j] + f * M + m] : T(0);
    an[j] = T(0);
    ad[j] = T(0);
  }
  __syncthreads();
  const int l1 = min(span, (warp + 1) * kSegment);
  const T* xr = xs + lane * kXStride;
#pragma unroll 2
  for (int l = warp * kSegment; l < l1; ++l) {
    T hv[kJ];
    load_row<T, kJ>(hv, hs + l * kStride);
    T r0 = T(0), r1 = T(0);
#pragma unroll
    for (int j = 0; j < kJ; j += 2) {
      r0 += wg[j] * hv[j];
      r1 += wg[j + 1] * hv[j + 1];
    }
    const T r = floor_below(r0 + r1, eps);
    const T b = reciprocal(r), a = xr[l] * (b * b);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      an[j] += a * hv[j];
      ad[j] += b * hv[j];
    }
  }
  // the warps' sums, added in warp order: the numerators, then the
  // denominators, kReduceWarps warps at a time
  T* sums = red + kReduceWarps * kJ * 32;  // [2 kJ][32], past the warps' rows
  for (int q = 0; q < 2; ++q) {
    for (int w0 = 0; w0 < kFrameWarps; w0 += kReduceWarps) {
      __syncthreads();
      if (warp >= w0 && warp < w0 + kReduceWarps) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) red[((warp - w0) * kJ + j) * 32 + lane] = q == 0 ? an[j] : ad[j];
      }
      __syncthreads();
      for (int i = tid; i < kJ * 32; i += kThreads) {
        T v = w0 == 0 ? red[i] : sums[q * kJ * 32 + i] + red[i];
#pragma unroll
        for (int u = 1; u < kReduceWarps; ++u) v += red[u * kJ * 32 + i];
        sums[q * kJ * 32 + i] = v;
      }
    }
  }
  __syncthreads();
  const int spans = gridDim.x;
  if (spans > 1) {
    T* mine = part + (static_cast<long long>(blockIdx.y) * spans + blockIdx.x) * 2 * kJ * 32;
    for (int i = tid; i < 2 * kJ * 32; i += kThreads) mine[i] = sums[i];
    if (!hopper::last_to_arrive(&tickets[blockIdx.y], spans, &flag_s)) return;
    const T* group = part + static_cast<long long>(blockIdx.y) * spans * 2 * kJ * 32;
    for (int i = tid; i < 2 * kJ * 32; i += kThreads) {
      T v = T(0);
      for (int c = 0; c < spans; ++c) v += __ldcg(group + static_cast<long long>(c) * 2 * kJ * 32 + i);
      sums[i] = v;
    }
    __syncthreads();
  }
  const int n_bins = min(bins, F - f_base);
  if (mode == 0) {
    for (int i = tid; i < n_bins * M * J; i += kThreads) {
      const int row = i / J, j = i % J;
      const long long o = (static_cast<long long>(row % M) * F + f_base + row / M) * J + j;
      out0[o] = sums[j * 32 + row];
      out1[o] = sums[(kJ + j) * 32 + row];
    }
  } else if (mode == 1) {
    for (int i = tid; i < n_bins * J; i += kThreads) {
      const int b = i / J, j = i % J;
      const long long sf = static_cast<long long>(j / K) * F + f_base + b;
      T num = mul_rn(g[sf * M], sums[j * 32 + b * M]);
      T den = mul_rn(g[sf * M], sums[(kJ + j) * 32 + b * M]);
      for (int mm = 1; mm < M; ++mm) {
        const T gv = g[sf * M + mm];
        num = add_rn(num, mul_rn(gv, sums[j * 32 + b * M + mm]));
        den = add_rn(den, mul_rn(gv, sums[(kJ + j) * 32 + b * M + mm]));
      }
      const long long o = sf * K + j % K;
      out0[o] = w[o] * sqrt(num / floor_below(den, eps));
    }
  } else {
    for (int i = tid; i < n_bins * S * M; i += kThreads) {
      const int b = i / (S * M), s = (i / M) % S, mm = i % M;
      const long long sf = static_cast<long long>(s) * F + f_base + b;
      T num = mul_rn(w[sf * K], sums[s * K * 32 + b * M + mm]);
      T den = mul_rn(w[sf * K], sums[(kJ + s * K) * 32 + b * M + mm]);
      for (int k = 1; k < K; ++k) {
        const T wv = w[sf * K + k];
        num = add_rn(num, mul_rn(wv, sums[(s * K + k) * 32 + b * M + mm]));
        den = add_rn(den, mul_rn(wv, sums[(kJ + s * K + k) * 32 + b * M + mm]));
      }
      const long long o = sf * M + mm;
      out0[o] = g[o] * sqrt(num / floor_below(den, eps));
    }
  }
}

// ---------------------------------------------------------- bin statistics

// A block per (32-frame tile, chunk of bins), a lane per frame with H[:, t]
// in registers.  The chunk's W, g and x come into shared memory by
// asynchronous copies, all in flight at once; each warp then forms its bins'
// Wg there and sweeps them, the warps taking the chunk's bins in turn.
// fused: the new activations into out0 (S, K, T); else the sums into out0
// and out1.  part: (chunks, 2, J, T) partials; tickets: one a tile.  Shared
// memory: bin_smem_bytes.
template <typename T, int kJ>
__global__ void __launch_bounds__(kBinWarps * 32, 2) bin_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                                             const T* __restrict__ g, const T* __restrict__ h,
                                                             T* __restrict__ out0, T* __restrict__ out1,
                                                             T* __restrict__ part, unsigned* __restrict__ tickets,
                                                             int fused, int M, int S, int K, int F, int nT,
                                                             int chunk_bins, T eps) {
  extern __shared__ __align__(16) unsigned char dyn_s[];
  __shared__ int sj_s[kJ], kj_s[kJ];
  __shared__ int flag_s;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int J = S * K;
  const int tile = blockIdx.x, chunk = blockIdx.y, chunks = gridDim.y;
  const int t = tile * kTile + lane;
  const bool live = t < nT;
  const int f0 = chunk * chunk_bins, nb = min(chunk_bins, F - f0);
  T* wg = reinterpret_cast<T*>(dyn_s);  // [nb][M][kJ]
  T* xw = wg + chunk_bins * M * kJ;     // [nb][M][32]
  T* wraw = xw + chunk_bins * M * kTile;  // [S][nb][K]
  T* graw = wraw + S * chunk_bins * K;    // [S][nb][M]
  for (int s = 0; s < S; ++s) {
    const T* ws = w + (static_cast<long long>(s) * F + f0) * K;
    for (int i = tid; i < nb * K; i += blockDim.x) copy_async(&wraw[s * nb * K + i], ws + i, true);
    const T* gs = g + (static_cast<long long>(s) * F + f0) * M;
    for (int i = tid; i < nb * M; i += blockDim.x) copy_async(&graw[s * nb * M + i], gs + i, true);
  }
  for (int m = 0; m < M; ++m) {
    const T* xm = x + (static_cast<long long>(m) * F + f0) * nT + t;
    for (int b = warp; b < nb; b += kBinWarps) {
      copy_async(&xw[(b * M + m) * kTile + lane], live ? xm + static_cast<long long>(b) * nT : x, live);
    }
  }
  copy_async_commit();
  for (int j = tid; j < kJ; j += blockDim.x) {
    sj_s[j] = j < J ? j / K : 0;
    kj_s[j] = j < J ? j % K : 0;
  }
  T hv[kJ], an[kJ], ad[kJ];
  load_h<T, kJ>(hv, h, J, nT, t, live);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    an[j] = T(0);
    ad[j] = T(0);
  }
  copy_async_wait<0>();
  __syncthreads();
  for (int b = warp; b < nb; b += kBinWarps) {
    for (int m = 0; m < M; ++m) {
      for (int j = lane; j < kJ; j += 32) {
        const int sb = sj_s[j] * nb + b;
        wg[(b * M + m) * kJ + j] = j < J ? wraw[sb * K + kj_s[j]] * graw[sb * M + m] : T(0);
      }
    }
  }
  __syncwarp();
  if (live) {
    for (int b = warp; b < nb; b += kBinWarps) {
      for (int m = 0; m < M; ++m) {
        const int q = b * M + m;
        T wv[kJ];
        load_row<T, kJ>(wv, wg + q * kJ);
        const T r = floor_below(dot<T, kJ>(wv, hv), eps);
        const T bb = reciprocal(r), a = xw[q * kTile + lane] * (bb * bb);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          an[j] += a * wv[j];
          ad[j] += bb * wv[j];
        }
      }
    }
  }
  // the warps' sums, added in warp order
  __syncthreads();
  T(*acc_s)[kTile] = reinterpret_cast<T(*)[kTile]>(dyn_s);
  for (int v = 0; v < kBinWarps; ++v) {
    if (warp == v) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        acc_s[j][lane] = v == 0 ? an[j] : acc_s[j][lane] + an[j];
        acc_s[kJ + j][lane] = v == 0 ? ad[j] : acc_s[kJ + j][lane] + ad[j];
      }
    }
    __syncthreads();
  }
  const long long plane = static_cast<long long>(J) * nT;
  T* mine = part + static_cast<long long>(chunk) * 2 * plane;
  for (int i = tid; i < 2 * J * kTile; i += blockDim.x) {
    const int q = i / (J * kTile), j = (i / kTile) % J, l = i % kTile;
    const int tt = tile * kTile + l;
    if (tt < nT) mine[q * plane + static_cast<long long>(j) * nT + tt] = acc_s[q * kJ + j][l];
  }
  if (!hopper::last_to_arrive(&tickets[tile], chunks, &flag_s)) return;
  for (int i = tid; i < J * kTile; i += blockDim.x) {
    const int j = i / kTile, l = i % kTile;
    const int tt = tile * kTile + l;
    if (tt >= nT) continue;
    const long long o = static_cast<long long>(j) * nT + tt;
    T num = T(0), den = T(0);
#pragma unroll 8  // loads in flight; the adds stay in chunk order
    for (int c = 0; c < chunks; ++c) {
      num += __ldcg(part + static_cast<long long>(c) * 2 * plane + o);
      den += __ldcg(part + static_cast<long long>(c) * 2 * plane + plane + o);
    }
    if (fused) {
      out0[o] = h[o] * sqrt(num / floor_below(den, eps));
    } else {
      out0[o] = num;
      out1[o] = den;
    }
  }
}

// bin statistics: shared memory of a chunk (ops/mnmf_mu.py::_plan keeps it
// within kBinSmem)
template <typename T, int kJ>
size_t bin_smem_bytes(int chunk_bins, int M, int S, int K) {
  const size_t staged = static_cast<size_t>(chunk_bins) * (M * kJ + M * kTile + S * K + S * M);
  const size_t sums = 2 * kJ * kTile;
  return (staged > sums ? staged : sums) * sizeof(T);
}

// ------------------------------------------------------------------ launch

template <typename T, int kJ>
cudaError_t launch_j(int entry, int fused, const T* x, const T* w, const T* g, const T* h, T* out0, T* out1,
                     void* part, unsigned* tickets, int M, int S, int K, int F, int nT, int chunk_bins, T eps,
                     cudaStream_t stream) {
  const dim3 rows((nT + kRowThreads - 1) / kRowThreads, (F + row_bins<T>() - 1) / row_bins<T>());
  switch (entry) {
    case 0:
      row_kernel<T, kJ, false><<<rows, kRowThreads, 0, stream>>>(x, w, g, h, out0, nullptr, nullptr, M, S, K, F, nT,
                                                                 eps);
      break;
    case 1:
    case 2: {
      constexpr int kSmem = frame_smem_bytes<T, kJ>();
      auto kernel = frame_kernel<T, kJ>;
      // dynamic shared memory opted into, per device
      static bool allowed[kMaxDevices] = {};
      int device = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err != cudaSuccess) return err;
      if (device >= kMaxDevices) return cudaErrorInvalidDevice;
      if (!allowed[device]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
        if (err != cudaSuccess) return err;
        allowed[device] = true;
      }
      const int bins = 32 / M;
      const dim3 grid((nT + kFrameWarps * frame_segment<T>() - 1) / (kFrameWarps * frame_segment<T>()),
                      (F + bins - 1) / bins);
      kernel<<<grid, kFrameWarps * 32, kSmem, stream>>>(x, w, g, h, out0, out1, static_cast<T*>(part), tickets,
                                                          fused ? entry : 0, M, S, K, F, nT, eps);
      break;
    }
    case 3: {
      const size_t smem = bin_smem_bytes<T, kJ>(chunk_bins, M, S, K);
      if (smem > kBinSmem) return cudaErrorInvalidValue;
      auto kernel = bin_kernel<T, kJ>;
      static bool allowed[kMaxDevices] = {};
      int device = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err != cudaSuccess) return err;
      if (device >= kMaxDevices) return cudaErrorInvalidDevice;
      if (!allowed[device]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBinSmem));
        if (err != cudaSuccess) return err;
        allowed[device] = true;
      }
      const int tiles = (nT + kTile - 1) / kTile, chunks = (F + chunk_bins - 1) / chunk_bins;
      kernel<<<dim3(tiles, chunks), kBinWarps * 32, smem, stream>>>(x, w, g, h, out0, out1, static_cast<T*>(part),
                                                                   tickets, fused, M, S, K, F, nT, chunk_bins, eps);
      break;
    }
    default:
      row_kernel<T, kJ, true><<<rows, kRowThreads, 0, stream>>>(x, w, g, h, out0, static_cast<double*>(part), tickets,
                                                                M, S, K, F, nT, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int entry, int fused, const void* x, const void* w, const void* g, const void* h, void* out0,
                   void* out1, void* part, void* tickets, int M, int S, int K, int F, int nT, int chunk_bins,
                   double eps, cudaStream_t stream) {
  auto* xp = static_cast<const T*>(x);
  auto* wp = static_cast<const T*>(w);
  auto* gp = static_cast<const T*>(g);
  auto* hp = static_cast<const T*>(h);
  auto* o0 = static_cast<T*>(out0);
  auto* o1 = static_cast<T*>(out1);
  auto* tk = static_cast<unsigned*>(tickets);
  const T e = static_cast<T>(eps);
  return launch_j<T, kMaxJ>(entry, fused, xp, wp, gp, hp, o0, o1, part, tk, M, S, K, F, nT, chunk_bins, e, stream);
}

}  // namespace

// entry: 0 weights, 1 basis, 2 gains, 3 activation, 4 fit (ops/mnmf_mu.py::
// ENTRIES); fused: apply the update (entries 1-3), else write the sums into
// out0 and out1.  dtype: 0 float32, 1 float64.  part and tickets: the
// activation's (chunks, 2, J, T) partials and one ticket a 32-frame tile,
// the fit's one double a block and one ticket; tickets zero before the
// first launch, and left so.  Returns a CUDA error code, 0 on success.
extern "C" int fastmnmf_mu(int entry, int fused, const void* x, const void* w, const void* g, const void* h,
                           void* out0, void* out1, void* part, void* tickets, int dtype, int M, int S, int K, int F,
                           int T, int chunk_bins, double eps, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (entry < 0 || entry > 4 || dtype < 0 || dtype > 1) return invalid;
  if (M < 1 || M > kMaxM || S < 1 || S > kMaxS || K < 1 || S * K > kMaxJ || F < 0 || T < 0) return invalid;
  if (entry > 0 && (part == nullptr || tickets == nullptr)) return invalid;
  if (entry == 3 && chunk_bins < 1) return invalid;
  if (!fused && (entry == 1 || entry == 2 || entry == 3) && out1 == nullptr) return invalid;
  if (F == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
                        ? launch<float>(entry, fused, x, w, g, h, out0, out1, part, tickets, M, S, K, F, T,
                                        chunk_bins, eps, s)
                        : launch<double>(entry, fused, x, w, g, h, out0, out1, part, tickets, M, S, K, F, T,
                                         chunk_bins, eps, s);
  return static_cast<int>(err);
}

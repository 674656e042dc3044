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
// that is 23.1 MB, about 6.9 us at the H100's 3.35 TB/s; at C = N = 5 it
// does about 8 flops per byte of X, against the card's 20 for f32 outside
// the tensor cores, so it is bound by bytes at every C.
//
// Design; ops/cov_kernel.py::k1_launch_plan lays out each launch:
//  * Blocks.  A block takes a group of `bins` consecutive bins and one of
//    `splits` spans of `span` frames; the grid is groups x splits.  Where
//    the groups alone give about two blocks per SM (F = 2049) there is one
//    split; at small F (65, 513) the frame axis is split across blocks
//    until they do.
//  * X into shared memory once, by TMA.  A block walks its span in chunks
//    of `chunk` frames (an even number): one chunk where the span fits in
//    shared memory beside a second block on the SM, else a ring of two
//    stages.  For each chunk the block issues 1-D bulk copies
//    (cp.async.bulk) of X and of the weights, each of a run's whole 16-byte
//    units.  A copy holds its issuing warp until every copy of that
//    instruction is taken, whatever its size, so copies are few and long:
//    where the chunk is the whole frame axis, a channel's rows of a group of
//    bins are one contiguous run and one copy; otherwise there is one copy
//    per (channel, bin) row.  The runs go round the warps, weights first,
//    then group by group.  A run that does not start or end on 16 bytes
//    (odd T, odd offsets) has at most 12 bytes at either end outside the
//    copy; its thread loads them with plain loads and stores them into the
//    stage.  Every element of X and of the weights is read from device
//    memory once.
//  * Barriers.  Each stage has one `full` mbarrier per group of bins
//    (kGroups), the weights riding on group 0's: a thread expects its
//    copies' bytes on its run's group before it issues them, and lane 0 of
//    each warp arrives once the warp's copies are issued and its end words
//    stored.  A warp waits only for the weights and its own bins, so the
//    groups asked for first are contracted while the rest land.  A stage
//    is refilled after a block barrier.
//  * Contraction in registers from shared memory.  C <= 4 with N <= 4 has
//    its own instances: one warp per bin, 8 bins per block, each lane
//    keeping all C^2 x N sums of its frames (at most 64).  Any other C and
//    N take the generic instance: a bin's channel pairs (kPairs at a time)
//    and weight rows (kRows at a time) are cut into units, each lane of a
//    unit's warp keeping 2 x kPairs x kRows sums; the plan packs 8 / units
//    bins into a block.  Past 8 units a bin has the block to itself, and
//    each warp walks several units per chunk, adding each unit's warp sums
//    into the block's shared sums, chunk by chunk.  Plain f32 FMA: TF32
//    would not hold 1e-4.
//  * Fixed-order sums.  A warp sums its lanes by a transposing tree
//    (warp_sums: 31 shuffles for 32 sums, where a butterfly per sum takes
//    160; shuffles are the scarce unit here).  With one split a block
//    writes `out`; otherwise it writes its (C^2, bins, N) sums to its
//    scratch row, and the last block of its group to take a ticket sums the
//    group's rows in split order, scales by 1/T, writes `out` and resets
//    the ticket to 0.  No float atomics: every launch gives the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no fast math).  With -DK1_TIMELINE, thread 0 of every
// block also stamps %globaltimer at the boundaries of the kernel's phases
// (K1_STAMP below), read back by k1_stamps.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"

namespace {

using namespace hopper;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxStages = 2;
constexpr int kGroups = 4;  // groups of a block's bins, each with its own mbarrier per stage
constexpr int kMaxC = 4, kMaxN = 4;  // the specialised instances: C, N <= these
constexpr int kPairs = 4;  // channel pairs of one generic unit
constexpr int kRows = 8;   // weight rows of one generic unit
constexpr int kAcc = 2 * kPairs * kRows;  // sums per lane, 64; the specialised C^2 N <= 64 too
constexpr int kMaxDevices = 64;

#ifdef K1_TIMELINE
constexpr int kStamps = 8;  // per block
constexpr int kStampBlocks = 4096;
__device__ unsigned long long g_stamps[kStampBlocks * kStamps];
#define K1_STAMP(k)                                                                \
  do {                                                                             \
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {                           \
      unsigned long long t;                                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                        \
      g_stamps[blockIdx.x * kStamps + (k)] = t;                                    \
    }                                                                              \
  } while (0)
#else
#define K1_STAMP(k) \
  do {              \
  } while (0)
#endif

// bytes of a stage's slot for one row of `chunk` elements of `size` bytes,
// with room for a start up to 15 bytes past a 16-byte boundary
__host__ __device__ __forceinline__ size_t slot_bytes(int chunk, int size) {
  return (static_cast<size_t>(chunk) * size + 15) / 16 * 16 + 16;
}

__host__ __device__ __forceinline__ size_t stage_bytes(int C, int N, int bins, int chunk) {
  return static_cast<size_t>(C) * bins * slot_bytes(chunk, 8) +
         static_cast<size_t>(N) * slot_bytes(chunk, 4);
}

// the block's (C^2, bins, N) sums, after the stages
__host__ __device__ __forceinline__ size_t sums_bytes(int C, int N, int bins) {
  return (static_cast<size_t>(C) * C * bins * N * 4 + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int generic_units(int C, int N) {
  const int pairs = C * (C + 1) / 2;
  return (pairs + kPairs - 1) / kPairs * ((N + kRows - 1) / kRows);
}

// A stage keeps a row at its source's offset mod 16, so that 16-byte runs
// of the source map to 16-byte runs of the slot.
template <typename E>
__device__ __forceinline__ const E* staged(const unsigned char* slot, const E* src) {
  return reinterpret_cast<const E*>(slot + (reinterpret_cast<uintptr_t>(src) & 15));
}

struct Block {
  const float2* x;
  const float* w;
  int C, N, F, T, bins, f0, nb;
  size_t xslot, wslot;
  bool whole;  // one chunk of all T frames: a channel's rows of a bin group are one run
  int gb;      // bins per group: max(1, bins / kGroups)

  __device__ const float2* x_row(int c, int b, int t0) const {
    return x + (static_cast<size_t>(c) * F + f0 + b) * T + t0;
  }
  __device__ const float* w_row(int n, int t0) const { return w + static_cast<size_t>(n) * T + t0; }
  __device__ const unsigned char* x_slot(const unsigned char* stage, int c, int b) const {
    return stage + (static_cast<size_t>(c) * bins + b) * xslot;
  }
  __device__ const unsigned char* w_slot(const unsigned char* stage, int n) const {
    return stage + static_cast<size_t>(C) * bins * xslot + static_cast<size_t>(n) * wslot;
  }
  // frame t0 of row (c, b) in the stage: its own slot, or, for a whole
  // chunk, row b of channel c's run, which starts in the channel's first slot
  __device__ const float2* x_staged(const unsigned char* stage, int c, int b, int t0) const {
    return whole ? staged(x_slot(stage, c, 0), x_row(c, 0, 0)) + static_cast<size_t>(b) * T
                 : staged(x_slot(stage, c, b), x_row(c, b, t0));
  }
};

// Run r of a chunk, a run being what one bulk copy brings.  Runs 0..N-1 are
// the weights' rows (group 0); then, group by group of gb bins, X's
// channels: for a whole chunk one run per channel of the group's rows, else
// one run per (channel, bin).  [src, end) in device memory; dst is where src
// lands in the stage; src == end for a bin past the last.
struct Run {
  uintptr_t src, end;
  unsigned char* dst;
  int group;
};

__device__ __forceinline__ int chunk_runs(const Block& blk) {
  const int groups = (blk.nb + blk.gb - 1) / blk.gb;
  return blk.N + blk.C * groups * (blk.whole ? 1 : blk.gb);
}

__device__ __forceinline__ Run chunk_run(const Block& blk, unsigned char* stage, int r, int t0,
                                         int len) {
  if (r < blk.N) {
    const uintptr_t src = reinterpret_cast<uintptr_t>(blk.w_row(r, t0));
    return {src, src + 4 * static_cast<uintptr_t>(len),
            const_cast<unsigned char*>(blk.w_slot(stage, r)) + (src & 15), 0};
  }
  const int q = r - blk.N, per = blk.whole ? 1 : blk.gb;
  const int g = q / (blk.C * per), c = q % (blk.C * per) / per;
  const int b = g * blk.gb + q % per;  // the run's first bin
  const int rows = blk.whole ? min(blk.gb, blk.nb - b) : (b < blk.nb ? 1 : 0);
  const uintptr_t src = reinterpret_cast<uintptr_t>(blk.x_row(c, b, t0));
  const unsigned char* dst = blk.whole
                                 ? reinterpret_cast<const unsigned char*>(blk.x_staged(stage, c, b, t0))
                                 : blk.x_slot(stage, c, b) + (src & 15);
  return {src, src + 8 * static_cast<uintptr_t>(rows) * len, const_cast<unsigned char*>(dst), g};
}

// Every thread of the block: bring frames [t0, t0 + len) of the block's
// runs into `stage`.  Runs go round the warps (lane l of warp w takes runs
// 8 l + w, 8 l + w + kThreads, ...): a warp is held at a bulk copy until
// the copies of all its lanes are taken, so each warp gets few.  A thread
// expects each copy's bytes on its group's barrier before it issues it and
// stores its runs' plain-loaded ends; then lane 0 of each warp arrives on
// every group's barrier (kWarps arrivals per phase).
__device__ void load_chunk(const Block& blk, unsigned char* stage, uint64_t* full, int t0, int len) {
  const int runs = chunk_runs(blk);
  for (int r = (threadIdx.x & 31) * kWarps + (threadIdx.x >> 5); r < runs; r += kThreads) {
    const Run row = chunk_run(blk, stage, r, t0, len);
    uintptr_t lo = up16(row.src), hi = down16(row.end);
    if (hi > lo) {
      mbar_expect_tx(&full[row.group], static_cast<unsigned>(hi - lo));
      bulk_copy(row.dst + (lo - row.src), reinterpret_cast<const void*>(lo),
                static_cast<unsigned>(hi - lo), &full[row.group]);
    } else {
      lo = hi = row.end;  // no whole 16 bytes: every word by a plain load
    }
    // at most 3 words at either end outside [lo, hi); all loads first, then
    // the stores
    unsigned v[6];
    uintptr_t at[6];
    bool in[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      at[i] = row.src + 4 * i;
      in[i] = at[i] < lo;
      at[3 + i] = hi + 4 * i;
      in[3 + i] = at[3 + i] < row.end;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (in[i]) v[i] = __ldg(reinterpret_cast<const unsigned*>(at[i]));
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (in[i]) *reinterpret_cast<unsigned*>(row.dst + (at[i] - row.src)) = v[i];
    for (uintptr_t p = row.src + 12; p < lo; p += 4)  // the middle of a run under 48 bytes
      *reinterpret_cast<unsigned*>(row.dst + (p - row.src)) = __ldg(reinterpret_cast<const unsigned*>(p));
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int g = 0; g < kGroups; ++g) mbar_arrive(&full[g]);
}

// Channels (c, d) of pair q in _plane_index order: q < C the diagonal
// (q, q), then the c < d pairs.
__device__ __forceinline__ void pair_channels(int q, int C, int* c, int* d) {
  if (q < C) {
    *c = *d = q;
    return;
  }
  int r = q - C, cc = 0;
  while (r >= C - 1 - cc) r -= C - 1 - (cc++);
  *c = cc;
  *d = cc + 1 + r;
}

// One step of warp_sums: a lane keeps half of v[kOff, kOff + 2o) (the upper
// half where its bit o is set) and adds its partner's copy of that half.
template <int kOff, int o>
__device__ __forceinline__ void keep_half(float (&v)[kAcc], int lane) {
  const bool up = lane & o;
#pragma unroll
  for (int k = 0; k < o; ++k) {
    const float send = up ? v[kOff + k] : v[kOff + k + o];
    const float keep = up ? v[kOff + k + o] : v[kOff + k];
    v[kOff + k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
  if constexpr (o > 1) keep_half<kOff, o / 2>(v, lane);
}

// The sums over the warp's lanes of v[kOff + i], i < 32: lane i gets the
// i-th, by a fixed tree of 31 shuffles (a butterfly per value would take
// 160).  v is overwritten.
template <int kOff>
__device__ __forceinline__ float warp_sums(float (&v)[kAcc], int lane) {
  keep_half<kOff, 16>(v, lane);
  return v[kOff];
}

// A generic unit: bin b, pairs q0 .. q0 + nq - 1 and weight rows n0 .. n0 +
// nt - 1 (nq = nt = 0 for a unit slot past the block's last bin).
struct Unit {
  int b, q0, n0, nq, nt;
};

__device__ __forceinline__ Unit generic_unit(int us, int C, int N, int nb) {
  const int units = generic_units(C, N), tiles = (N + kRows - 1) / kRows;
  const int b = us / units, u = us % units;
  const int q0 = u / tiles * kPairs, n0 = u % tiles * kRows;
  if (b >= nb) return {b, q0, n0, 0, 0};
  return {b, q0, n0, min(kPairs, C * (C + 1) / 2 - q0), min(kRows, N - n0)};
}

// Index in the block's sums of a unit's sum i, or -1 where it holds none (a
// pair or row past its last, the imaginary part of a diagonal).  Sum i is
// (pair j, re or im, row kk) at (2 j + im) kRows + kk.
__device__ __forceinline__ int unit_entry(const Unit& un, int i, int C, int N, int bins) {
  const int j = i / (2 * kRows), im = (i / kRows) & 1, kk = i % kRows, q = un.q0 + j;
  if (j >= un.nq || kk >= un.nt || (im && q < C)) return -1;
  const int p = (q < C ? q : C + 2 * (q - C)) + im;
  return (p * bins + un.b) * N + un.n0 + kk;
}

template <int kC, int kN>  // kC = 0: the generic instance, C and N at run time
__global__ void __launch_bounds__(kThreads, 2)
covariance_kernel(const float2* __restrict__ x,     // (C, F, T)
                  const float* __restrict__ w,      // (N, T)
                  float* __restrict__ out,          // (C^2, F, N)
                  float* __restrict__ part,         // (groups, splits, C^2, bins, N) if splits > 1
                  unsigned* __restrict__ tickets,   // (groups,) if splits > 1
                  int C_, int N_, int F, int T, int bins, int chunk, int stages, int splits,
                  int span) {
  constexpr bool kGeneric = kC == 0;
  const int C = kGeneric ? C_ : kC;
  const int N = kGeneric ? N_ : kN;
  const int P = C * C;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_s[kMaxStages][kGroups];
  __shared__ int flag_s;

  K1_STAMP(0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x / splits, split = blockIdx.x % splits;
  const int f0 = g * bins;
  const int t_begin = split * span, t_end = min(T, t_begin + span);
  const int n_chunks = (t_end - t_begin + chunk - 1) / chunk;  // >= 1: no split is empty
  const Block blk{x, w, C, N, F, T, bins, f0, min(bins, F - f0), slot_bytes(chunk, 8),
                  slot_bytes(chunk, 4), splits == 1 && n_chunks == 1, max(1, bins / kGroups)};
  const size_t sbytes = stage_bytes(C, N, bins, chunk);
  float* sums = reinterpret_cast<float*>(smem + stages * sbytes);

  // a warp takes a bin (specialised) or a bin's (pairs, rows) unit; past 8
  // units (bins = 1) each warp walks `rounds` of them per chunk
  const int rounds = kGeneric ? (bins * generic_units(C, N) + kWarps - 1) / kWarps : 1;

  if (rounds > 1)  // units add into the sums chunk by chunk
    for (int i = tid; i < P * bins * N; i += kThreads) sums[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      for (int i = 0; i < kGroups; ++i) mbar_init(&full_s[s][i], kWarps);
    mbar_fence_init();
  }
  __syncthreads();
  K1_STAMP(1);
  auto load = [&](int k) {
    const int t0 = t_begin + k * chunk;
    load_chunk(blk, smem + (k % stages) * sbytes, full_s[k % stages], t0, min(chunk, t_end - t0));
  };
  for (int k = 0; k < min(stages, n_chunks); ++k) load(k);
  K1_STAMP(2);

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  const Unit mine = kGeneric ? generic_unit(warp, C, N, blk.nb) : Unit{warp, 0, 0, 0, 0};

  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % stages;
    const unsigned char* stage = smem + s * sbytes;
    const int t0 = t_begin + k * chunk, len = min(chunk, t_end - t0);
    // a warp waits for the weights (group 0) and its own bins' group
    auto wait_for = [&](int b) {
      mbar_wait(&full_s[s][0], (k / stages) & 1);
      mbar_wait(&full_s[s][b / blk.gb], (k / stages) & 1);
    };

    if constexpr (!kGeneric) {
      constexpr int kP = kC * kC;
      const int b = warp;
      if (b < blk.nb) {
        wait_for(b);
        if (k == 0) K1_STAMP(3);
        const float2* xr[kC];
        const float* wr[kN];
#pragma unroll
        for (int c = 0; c < kC; ++c) xr[c] = blk.x_staged(stage, c, b, t0);
#pragma unroll
        for (int n = 0; n < kN; ++n) wr[n] = staged(blk.w_slot(stage, n), blk.w_row(n, t0));
        // two frames in flight per lane where the registers allow it
        constexpr int kUnroll = kP * kN <= 36 ? 2 : 1;
#pragma unroll kUnroll
        for (int t = lane; t < len; t += 32) {
          float2 xv[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) xv[c] = xr[c][t];
          float pl[kP];
          int q = 0;
#pragma unroll
          for (int c = 0; c < kC; ++c) pl[q++] = xv[c].x * xv[c].x + xv[c].y * xv[c].y;
#pragma unroll
          for (int c = 0; c < kC; ++c)
#pragma unroll
            for (int d = c + 1; d < kC; ++d) {
              pl[q++] = xv[c].x * xv[d].x + xv[c].y * xv[d].y;
              pl[q++] = xv[c].y * xv[d].x - xv[c].x * xv[d].y;
            }
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            const float wn = wr[n][t];
#pragma unroll
            for (int p = 0; p < kP; ++p) acc[p * kN + n] += pl[p] * wn;
          }
        }
      }
    } else {
      for (int r = 0; r < rounds; ++r) {
        const Unit un = rounds == 1 ? mine : generic_unit(warp + r * kWarps, C, N, blk.nb);
        if (un.nq == 0) continue;  // warp-uniform: no unit
        wait_for(un.b);
        if (k == 0) K1_STAMP(3);
        const float2* ra[kPairs];
        const float2* rb[kPairs];
        const float* wr[kRows];
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          int c = 0, d = 0;
          if (j < un.nq) pair_channels(un.q0 + j, C, &c, &d);
          ra[j] = blk.x_staged(stage, c, un.b, t0);
          rb[j] = blk.x_staged(stage, d, un.b, t0);
        }
#pragma unroll
        for (int kk = 0; kk < kRows; ++kk) {
          const int n = un.n0 + (kk < un.nt ? kk : 0);
          wr[kk] = staged(blk.w_slot(stage, n), blk.w_row(n, t0));
        }
        if (rounds > 1)
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
        for (int t = lane; t < len; t += 32) {
          float wv[kRows];
#pragma unroll
          for (int kk = 0; kk < kRows; ++kk) wv[kk] = kk < un.nt ? wr[kk][t] : 0.f;
#pragma unroll
          for (int j = 0; j < kPairs; ++j) {
            if (j < un.nq) {
              const float2 a = ra[j][t], c = rb[j][t];
              const float pr = a.x * c.x + a.y * c.y;  // |x_c|^2 on the diagonal
              const float pi = a.y * c.x - a.x * c.y;
#pragma unroll
              for (int kk = 0; kk < kRows; ++kk) {
                if (kk < un.nt) {
                  acc[(2 * j) * kRows + kk] += pr * wv[kk];
                  acc[(2 * j + 1) * kRows + kk] += pi * wv[kk];
                }
              }
            }
          }
        }
        if (rounds > 1) {  // one warp per unit: add its chunk sums into the block's
          const float v0 = warp_sums<0>(acc, lane), v1 = warp_sums<32>(acc, lane);
          const int e0 = unit_entry(un, lane, C, N, bins), e1 = unit_entry(un, 32 + lane, C, N, bins);
          if (e0 >= 0) sums[e0] += v0;
          if (e1 >= 0) sums[e1] += v1;
        }
      }
    }

    if (k + stages < n_chunks) {  // refill the stage once every warp is done with it
      __syncthreads();
      fence_proxy_async();
      load(k + stages);
    }
  }

  K1_STAMP(4);
  // ---- the block's sums: each warp its own, lanes summed by warp_sums ----
  if (rounds == 1) {
    if constexpr (kGeneric) {
      const float v0 = warp_sums<0>(acc, lane), v1 = warp_sums<32>(acc, lane);
      const int e0 = unit_entry(mine, lane, C, N, bins), e1 = unit_entry(mine, 32 + lane, C, N, bins);
      if (e0 >= 0) sums[e0] = v0;
      if (e1 >= 0) sums[e1] = v1;
    } else {
      constexpr int kUsed = kC * kC * kN;  // sum i is (plane i / kN, row i % kN)
      const float v0 = warp_sums<0>(acc, lane);
      if (warp < blk.nb && lane < kUsed) sums[(lane / kN * bins + warp) * kN + lane % kN] = v0;
      if constexpr (kUsed > 32) {
        const float v1 = warp_sums<32>(acc, lane);
        if (warp < blk.nb && 32 + lane < kUsed)
          sums[((32 + lane) / kN * bins + warp) * kN + (32 + lane) % kN] = v1;
      }
    }
  }
  __syncthreads();
  K1_STAMP(5);

  // ---- out, directly or through the group's split rows ----
  const float n_frames = static_cast<float>(T);
  const int per_plane = blk.nb * N;  // (b, n) of one plane, contiguous in out
  if (splits == 1) {
    for (int i = tid; i < P * per_plane; i += kThreads) {
      const int p = i / per_plane, r = i % per_plane;
      out[(static_cast<size_t>(p) * F + f0) * N + r] = sums[p * bins * N + r] / n_frames;
    }
    K1_STAMP(6);
    return;
  }
  const int E = P * bins * N;
  float* row = part + static_cast<size_t>(blockIdx.x) * E;
  for (int i = tid; i < E; i += kThreads) row[i] = sums[i];
  if (!last_to_arrive(&tickets[g], splits, &flag_s)) return;
  const float* rows = part + static_cast<size_t>(g) * splits * E;
  for (int i = tid; i < P * per_plane; i += kThreads) {
    const int p = i / per_plane, r = i % per_plane;
    const int e = p * bins * N + r;
    float v = 0.f;
#pragma unroll 8  // loads in flight; the adds stay in split order
    for (int s = 0; s < splits; ++s) v += __ldcg(rows + static_cast<size_t>(s) * E + e);
    out[(static_cast<size_t>(p) * F + f0) * N + r] = v / n_frames;
  }
  K1_STAMP(6);
}

template <int kC, int kN>
cudaError_t launch(const void* x, const void* w, void* out, void* part, void* tickets, int C, int N,
                   int F, int T, int bins, int chunk, int stages, int splits, int span, size_t smem,
                   cudaStream_t stream) {
  auto kernel = covariance_kernel<kC, kN>;
  // dynamic shared memory opted into, per device: static and dynamic
  // together past 48 KB need it
  static size_t allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[device] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed[device] = smem;
  }
  const long long blocks = static_cast<long long>((F + bins - 1) / bins) * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float2*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<unsigned*>(tickets), C, N, F, T, bins, chunk, stages,
      splits, span);
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch_c(const void* x, const void* w, void* out, void* part, void* tickets, int N,
                     int F, int T, int bins, int chunk, int stages, int splits, int span,
                     size_t smem, cudaStream_t s) {
  switch (N) {
    case 1: return launch<kC, 1>(x, w, out, part, tickets, kC, 1, F, T, bins, chunk, stages, splits, span, smem, s);
    case 2: return launch<kC, 2>(x, w, out, part, tickets, kC, 2, F, T, bins, chunk, stages, splits, span, smem, s);
    case 3: return launch<kC, 3>(x, w, out, part, tickets, kC, 3, F, T, bins, chunk, stages, splits, span, smem, s);
    case 4: return launch<kC, 4>(x, w, out, part, tickets, kC, 4, F, T, bins, chunk, stages, splits, span, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (C, F, T) complex64 viewed as float2; w: (N, T) f32; out: (C^2, F, N)
// f32; any C >= 1 and N >= 1.  bins, chunk, stages, splits, span,
// smem_bytes and specialised come from ops/cov_kernel.py::k1_launch_plan.
// With splits > 1, part holds ceil(F / bins) * splits * C^2 * bins * N f32
// and tickets ceil(F / bins) unsigned, zero before the first launch (the
// kernel leaves them zero); with splits = 1 both may be null.
// Returns the launch's cudaError_t (0 on success).
extern "C" int weighted_covariance_f32(const void* x, const void* w, void* out, void* part,
                                       void* tickets, int C, int N, int F, int T, int bins,
                                       int chunk, int stages, int splits, int span, int smem_bytes,
                                       int specialised, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (C < 1 || N < 1 || F < 1 || T < 1 || bins < 1 || bins > kWarps || chunk < 2 || chunk % 2 ||
      stages < 1 || stages > kMaxStages || splits < 1 || span < 1 ||
      static_cast<long long>(span) * splits < T || static_cast<long long>(span) * (splits - 1) >= T)
    return invalid;
  if (splits > 1 && (part == nullptr || tickets == nullptr)) return invalid;
  const bool fixed = C <= kMaxC && N <= kMaxN;
  if ((specialised != 0) != fixed) return invalid;
  // a warp per bin, or per unit of up to kWarps units in all (bins = 1 past that)
  if (bins != (fixed ? kWarps : max(1, kWarps / generic_units(C, N)))) return invalid;
  const size_t need = stages * stage_bytes(C, N, bins, chunk) + sums_bytes(C, N, bins);
  if (smem_bytes < 0 || static_cast<size_t>(smem_bytes) < need) return invalid;
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fixed ? C : 0) {
    case 1: err = launch_c<1>(x, w, out, part, tickets, N, F, T, bins, chunk, stages, splits, span, smem, s); break;
    case 2: err = launch_c<2>(x, w, out, part, tickets, N, F, T, bins, chunk, stages, splits, span, smem, s); break;
    case 3: err = launch_c<3>(x, w, out, part, tickets, N, F, T, bins, chunk, stages, splits, span, smem, s); break;
    case 4: err = launch_c<4>(x, w, out, part, tickets, N, F, T, bins, chunk, stages, splits, span, smem, s); break;
    default: err = launch<0, 0>(x, w, out, part, tickets, C, N, F, T, bins, chunk, stages, splits, span, smem, s);
  }
  return static_cast<int>(err);
}

#ifdef K1_TIMELINE
// Copies the first n stamps (block b's stamp k at b * 8 + k, ns of
// %globaltimer, 0 where not stamped) to host memory at dst and clears them all.
extern "C" int k1_stamps(void* dst, int n) {
  void* stamps = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&stamps, g_stamps);
  if (err == cudaSuccess)
    err = cudaMemcpy(dst, stamps, n * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  if (err == cudaSuccess) err = cudaMemset(stamps, 0, sizeof(g_stamps));
  return static_cast<int>(err);
}
#endif

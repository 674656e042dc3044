// Batched Hermitian eigensolver (kernel K3).
//
//   w[b], V[b] = eigh(A[b]),   A[b] Hermitian (complex) or symmetric (real), n x n
//
// with the eigenvalues in ascending order, as LAPACK returns them, and
// optionally the eigenvectors as the columns of V[b].  The lower triangle of
// each matrix is read (LAPACK's UPLO = 'L'); a matrix with a non-finite
// entry anywhere gives NaN eigenvalues and vectors.  Types: float32,
// float64, complex64, complex128 in and out; the arithmetic is float64
// whatever the type.
//
// No Pallas kernel stands behind it: it is the port's counterpart of the
// eigh that XLA compiles into the JAX package's jitted scan (the block-PSD
// models' small blocks, models/ipsdta.py; LD-PSDTF's 64 x 64 pencil and
// model covariances, models/psdtf.py; the C = 3 Riccati,
// algorithm/linalg.py).  torch.linalg.eigh reads cuSOLVER's info array on
// the host, so a step that calls it cannot be captured as a CUDA graph;
// this kernel reads nothing on the host.
//
// Bound: a launch reads each matrix once and writes its eigenvalues and
// vectors once; LAPACK's dense count of an eigendecomposition is 9 n^3
// FLOPs with vectors (4/3 n^3 without), four times that at a complex type
// (ops/eigh_kernel.py::eigh_cost).  At float64 (67 TFLOP/s on an H100 SXM
// through its FP64 tensor cores, the card's peak for the type) the small
// blocks (n <= 9) are bound by bytes, and 64 x 64 by operations.  A Jacobi
// method does several times LAPACK's count (about 4 n^3 a sweep with
// vectors, 5-10 sweeps); it is chosen for its simplicity and for being
// exact on a matrix that is already diagonal, not for its count.
//
// Design (ops/eigh_kernel.py::k3_launch_plan picks the group and the mode):
//  * One matrix per group of threads: for n <= 16 a group of 2-32 lanes of
//    one warp (several matrices per warp, each group synchronised by
//    __syncwarp on its lanes alone); above, one block of 256 threads per
//    matrix.  The matrix (both triangles) and V sit at float64 on m x m
//    (m = n rounded up to even), in shared memory where they fit (n <= 84
//    at complex128 with vectors: 32 m^2 bytes of the 232,448 a block may
//    take), else in a device workspace of one slot a block, the blocks
//    walking the batch (the same code: __syncthreads orders a block's
//    global writes as it does its shared ones).
//  * Parallel-ordered cyclic Jacobi.  A sweep is m - 1 rounds of the
//    round-robin tournament, m / 2 disjoint pairs (p, q) a round (an odd n
//    pairs one index with a dummy each round, which is skipped).  Each round:
//    every pair's rotation from the old (p, q) block (one phase), then the
//    column pass A <- A J and V <- V J, then the row pass A <- J^H A, with
//    each pair's own 2 x 2 block written exactly (diagonal, zero
//    off-diagonal).  For a_pq = g e^{i phi}: t = sign(tau) / (|tau| +
//    sqrt(1 + tau^2)), tau = (a_qq - a_pp) / (2 g), c = 1 / sqrt(1 + t^2),
//    S = t c e^{i phi}, J = [[c, S], [-conj(S), c]] on (p, q).
//  * Convergence per matrix, on the device: a pair is rotated only where
//    |a_pq| > eps |A|_F (eps = 2^-52, |A|_F the input's Frobenius norm,
//    summed in a fixed order so that a launch is deterministic).  The
//    eigenvalues then carry LAPACK's absolute error, about eps |A|, and
//    round-off fill-in between zero diagonal entries (a rank-deficient
//    matrix) is not chased.  A matrix stops after the first sweep that
//    rotated no pair; one that still rotated in its max_sweeps-th sweep
//    gives NaN eigenvalues and vectors, as a non-finite one does
//    (torch.linalg.eigh raised in both cases).
//  * Output: each eigenvalue's rank (ties by index) gives its column;
//    each eigenvector's entry of largest modulus (the first such) is made
//    real and positive; the writes are coalesced over the output's entries.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kMaxN = 2048;
constexpr int kSmemLimit = 232448;
constexpr int kMaxDevices = 64;

// complex or real scalar at float64
template <bool kComplex>
struct Num;

template <>
struct Num<false> {
  using T = double;
  static __device__ __forceinline__ T zero() { return 0.0; }
  static __device__ __forceinline__ T one() { return 1.0; }
  static __device__ __forceinline__ double re(T a) { return a; }
  static __device__ __forceinline__ double abs(T a) { return fabs(a); }
  static __device__ __forceinline__ double abs2(T a) { return a * a; }
  static __device__ __forceinline__ T conj(T a) { return a; }
  static __device__ __forceinline__ T mul(T a, T b) { return a * b; }
  static __device__ __forceinline__ T scale(double s, T a) { return s * a; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T sub(T a, T b) { return a - b; }
  static __device__ __forceinline__ T real(double a) { return a; }
  static __device__ __forceinline__ bool finite(T a) { return isfinite(a); }
};

template <>
struct Num<true> {
  using T = double2;
  static __device__ __forceinline__ T zero() { return make_double2(0.0, 0.0); }
  static __device__ __forceinline__ T one() { return make_double2(1.0, 0.0); }
  static __device__ __forceinline__ double re(T a) { return a.x; }
  static __device__ __forceinline__ double abs(T a) { return hypot(a.x, a.y); }
  static __device__ __forceinline__ double abs2(T a) { return a.x * a.x + a.y * a.y; }
  static __device__ __forceinline__ T conj(T a) { return make_double2(a.x, -a.y); }
  static __device__ __forceinline__ T mul(T a, T b) {
    return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
  }
  static __device__ __forceinline__ T scale(double s, T a) { return make_double2(s * a.x, s * a.y); }
  static __device__ __forceinline__ T add(T a, T b) { return make_double2(a.x + b.x, a.y + b.y); }
  static __device__ __forceinline__ T sub(T a, T b) { return make_double2(a.x - b.x, a.y - b.y); }
  static __device__ __forceinline__ T real(double a) { return make_double2(a, 0.0); }
  static __device__ __forceinline__ bool finite(T a) { return isfinite(a.x) && isfinite(a.y); }
};

// the element of the input or output at flat index e, as a float64 scalar
template <typename IO, bool kComplex>
struct Io;

template <typename IO>
struct Io<IO, false> {
  static __device__ __forceinline__ double load(const IO* p, long long e) { return static_cast<double>(p[e]); }
  static __device__ __forceinline__ void store(IO* p, long long e, double v) { p[e] = static_cast<IO>(v); }
};

template <typename IO>
struct Io<IO, true> {
  static __device__ __forceinline__ double2 load(const IO* p, long long e) {
    return make_double2(static_cast<double>(p[2 * e]), static_cast<double>(p[2 * e + 1]));
  }
  static __device__ __forceinline__ void store(IO* p, long long e, double2 v) {
    p[2 * e] = static_cast<IO>(v.x);
    p[2 * e + 1] = static_cast<IO>(v.y);
  }
};

// float64 words of one group's slot, in shared memory or the workspace
// (even, so every slot starts on 16 bytes): A, V (with vectors), five per
// pair (c, S re, S im, the new a_pp and a_qq), three per index (eigenvalue,
// phase re, im), the norm, and the ints (a flag per pair, rank and inverse
// per index) two to a word
__host__ __device__ inline long long group_words(int n, bool complex_, bool vectors) {
  const long long m = n + (n & 1);
  const long long width = complex_ ? 2 : 1;
  const long long words = (vectors ? 2 : 1) * m * m * width + 5 * (m / 2) + 3 * m + 1 + (m / 2 + 2 * m + 1) / 2;
  return words + (words & 1);
}

// the pair of round r, slot i, of the round-robin tournament on m indices
__device__ __forceinline__ void pair_of(int r, int i, int m, int& p, int& q) {
  int a, b;
  if (i == 0) {
    a = r;
    b = m - 1;
  } else {
    a = (r + i) % (m - 1);
    b = (r - i + m - 1) % (m - 1);
  }
  p = min(a, b);
  q = max(a, b);
}

struct Group {
  int size;       // threads of the group
  int lane;       // this thread's index in it
  unsigned mask;  // the group's lanes in the warp (warp mode)

  __device__ __forceinline__ void sync() const {
    if (size > 32)
      __syncthreads();
    else
      __syncwarp(mask);
  }
  __device__ __forceinline__ bool any(bool v) const {
    return size > 32 ? __syncthreads_or(v) != 0 : __any_sync(mask, v) != 0;
  }
  __device__ __forceinline__ bool all(bool v) const {
    return size > 32 ? __syncthreads_and(v) != 0 : __all_sync(mask, v) != 0;
  }
};

template <typename IO, bool kComplex>
__global__ void eigh_kernel(const IO* __restrict__ in, IO* __restrict__ w_out, IO* __restrict__ v_out,
                            int* __restrict__ sweeps_out, double* __restrict__ workspace, long long batch, int n,
                            int vectors, int group_size, int max_sweeps) {
  using N = Num<kComplex>;
  using T = typename N::T;
  extern __shared__ double smem[];

  const int per_block = blockDim.x / group_size;
  const int g = threadIdx.x / group_size;
  Group grp;
  grp.size = group_size;
  grp.lane = threadIdx.x % group_size;
  grp.mask = group_size >= 32 ? 0xffffffffu : ((1u << group_size) - 1u) << ((threadIdx.x & 31) & ~(group_size - 1));

  const int m = n + (n & 1);
  const int half = m / 2;
  const long long slot_words = group_words(n, kComplex, vectors != 0);
  // a group's slot: its part of the block's shared memory, or the block's
  // slot of the workspace (one matrix a block)
  double* base = workspace != nullptr ? workspace + static_cast<long long>(blockIdx.x) * slot_words
                                      : smem + static_cast<long long>(g) * slot_words;
  T* A = reinterpret_cast<T*>(base);
  T* V = A + static_cast<long long>(m) * m;
  double* words = base + (vectors ? 2LL : 1LL) * m * m * (kComplex ? 2 : 1);
  double* rc = words;
  double* rs_re = rc + half;
  double* rs_im = rs_re + half;
  double* new_pp = rs_im + half;
  double* new_qq = new_pp + half;
  double* eig = new_qq + half;
  double* ph_re = eig + m;
  double* ph_im = ph_re + m;
  double* norm2 = ph_im + m;
  int* active = reinterpret_cast<int*>(norm2 + 1);
  int* rank = active + half;
  int* inverse = rank + m;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);

  const long long stride = static_cast<long long>(gridDim.x) * per_block;
  for (long long b = static_cast<long long>(blockIdx.x) * per_block + g; b < batch; b += stride) {
    grp.sync();  // the slot's last matrix is read out
    const IO* src = in + b * n * n * (kComplex ? 2 : 1);
    bool finite = true;
    double part = 0.0;  // this lane's share of |A|_F^2
    for (int e = grp.lane; e < n * n; e += grp.size) {
      const int i = e / n, j = e % n;
      const T x = Io<IO, kComplex>::load(src, e);
      finite = finite && N::finite(x);
      if (i > j) {
        A[i * m + j] = x;
        A[j * m + i] = N::conj(x);
        part += 2.0 * N::abs2(x);
      } else if (i == j) {
        A[i * m + i] = N::real(N::re(x));
        part += N::re(x) * N::re(x);
      }
      if (vectors) V[i * m + j] = i == j ? N::one() : N::zero();
    }
    const long long w_base = b * n;
    const long long v_base = b * n * n;
    if (!grp.all(finite)) {
      for (int e = grp.lane; e < n; e += grp.size) Io<IO, false>::store(w_out, w_base + e, nan);
      if (vectors) {
        T z;
        if constexpr (kComplex) z = make_double2(nan, nan); else z = nan;
        for (int e = grp.lane; e < n * n; e += grp.size) Io<IO, kComplex>::store(v_out, v_base + e, z);
      }
      if (sweeps_out != nullptr && grp.lane == 0) sweeps_out[b] = 0;
      continue;
    }
    // |A|_F^2 in a fixed order: a butterfly within each warp's lanes, then
    // (one matrix a block) the warps' sums in order, through eig
    for (int o = min(grp.size, 32) / 2; o > 0; o >>= 1) part += __shfl_xor_sync(grp.mask, part, o);
    if (grp.size > 32) {
      if ((threadIdx.x & 31) == 0) eig[threadIdx.x / 32] = part;
      grp.sync();
      if (grp.lane == 0) {
        double total = 0.0;
        for (int k = 0; k < grp.size / 32; ++k) total += eig[k];
        *norm2 = total;
      }
    } else if (grp.lane == 0) {
      *norm2 = part;
    }
    grp.sync();
    const double cutoff = DBL_EPSILON * sqrt(*norm2);

    int sweep = 0;
    bool converged = false;
    while (sweep < max_sweeps) {
      bool rotated = false;
      for (int r = 0; r < m - 1; ++r) {
        // the rotations of this round, from the (p, q) blocks before it
        for (int i = grp.lane; i < half; i += grp.size) {
          int p, q;
          pair_of(r, i, m, p, q);
          int on = 0;
          if (q < n) {
            const double app = N::re(A[p * m + p]), aqq = N::re(A[q * m + q]);
            const T apq = A[p * m + q];
            const double gabs = N::abs(apq);
            if (gabs > cutoff) {
              const double tau = (aqq - app) / (2.0 * gabs);
              const double t = fabs(tau) > 1e150 ? 0.5 / tau
                                                 : (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + sqrt(1.0 + tau * tau));
              const double c = 1.0 / sqrt(1.0 + t * t);
              const T S = N::scale(t * c / gabs, apq);
              rc[i] = c;
              if constexpr (kComplex) {
                rs_re[i] = S.x;
                rs_im[i] = S.y;
              } else {
                rs_re[i] = S;
                rs_im[i] = 0.0;
              }
              new_pp[i] = app - t * gabs;
              new_qq[i] = aqq + t * gabs;
              on = 1;
            }
          }
          active[i] = on;
          rotated = rotated || on;
        }
        grp.sync();
        // columns: A <- A J, V <- V J
        for (int e = grp.lane; e < n * half; e += grp.size) {
          const int i = e % half, k = e / half;
          if (!active[i]) continue;
          int p, q;
          pair_of(r, i, m, p, q);
          const double c = rc[i];
          T S;
          if constexpr (kComplex) S = make_double2(rs_re[i], rs_im[i]); else S = rs_re[i];
          const T Sc = N::conj(S);
          const T akp = A[k * m + p], akq = A[k * m + q];
          A[k * m + p] = N::sub(N::scale(c, akp), N::mul(Sc, akq));
          A[k * m + q] = N::add(N::mul(S, akp), N::scale(c, akq));
          if (vectors) {
            const T vkp = V[k * m + p], vkq = V[k * m + q];
            V[k * m + p] = N::sub(N::scale(c, vkp), N::mul(Sc, vkq));
            V[k * m + q] = N::add(N::mul(S, vkp), N::scale(c, vkq));
          }
        }
        grp.sync();
        // rows: A <- J^H A, each pair's own block exact
        for (int e = grp.lane; e < n * half; e += grp.size) {
          const int i = e % half, k = e / half;
          if (!active[i]) continue;
          int p, q;
          pair_of(r, i, m, p, q);
          if (k == p) {
            A[p * m + p] = N::real(new_pp[i]);
            A[q * m + p] = N::zero();
          } else if (k == q) {
            A[p * m + q] = N::zero();
            A[q * m + q] = N::real(new_qq[i]);
          } else {
            const double c = rc[i];
            T S;
            if constexpr (kComplex) S = make_double2(rs_re[i], rs_im[i]); else S = rs_re[i];
            const T apk = A[p * m + k], aqk = A[q * m + k];
            A[p * m + k] = N::sub(N::scale(c, apk), N::mul(S, aqk));
            A[q * m + k] = N::add(N::mul(N::conj(S), apk), N::scale(c, aqk));
          }
        }
        grp.sync();
      }
      ++sweep;
      if (!grp.any(rotated)) {
        converged = true;
        break;
      }
    }
    if (sweeps_out != nullptr && grp.lane == 0) sweeps_out[b] = sweep;
    if (!converged) {
      for (int e = grp.lane; e < n; e += grp.size) Io<IO, false>::store(w_out, w_base + e, nan);
      if (vectors) {
        T z;
        if constexpr (kComplex) z = make_double2(nan, nan); else z = nan;
        for (int e = grp.lane; e < n * n; e += grp.size) Io<IO, kComplex>::store(v_out, v_base + e, z);
      }
      continue;
    }

    // ranks (ties by index) and each vector's phase
    for (int j = grp.lane; j < n; j += grp.size) eig[j] = N::re(A[j * m + j]);
    grp.sync();
    for (int j = grp.lane; j < n; j += grp.size) {
      const double d = eig[j];
      int k = 0;
      for (int i = 0; i < n; ++i) k += (eig[i] < d) || (eig[i] == d && i < j);
      rank[j] = k;
      inverse[k] = j;
      if (vectors) {
        int top = 0;
        double best = -1.0;
        for (int i = 0; i < n; ++i) {
          const double a = N::abs2(V[i * m + j]);
          if (a > best) {
            best = a;
            top = i;
          }
        }
        const T v = V[top * m + j];
        const double mod = N::abs(v);
        if constexpr (kComplex) {
          ph_re[j] = v.x / mod;
          ph_im[j] = -v.y / mod;
        } else {
          ph_re[j] = v >= 0.0 ? 1.0 : -1.0;
          ph_im[j] = 0.0;
        }
      }
    }
    grp.sync();
    for (int e = grp.lane; e < n; e += grp.size) Io<IO, false>::store(w_out, w_base + e, eig[inverse[e]]);
    if (vectors) {
      for (int e = grp.lane; e < n * n; e += grp.size) {
        const int k = e / n, col = e % n;
        const int j = inverse[col];
        T ph;
        if constexpr (kComplex) ph = make_double2(ph_re[j], ph_im[j]); else ph = ph_re[j];
        Io<IO, kComplex>::store(v_out, v_base + e, N::mul(V[k * m + j], ph));
      }
    }
  }
}

template <typename IO, bool kComplex>
cudaError_t launch(const void* in, void* w, void* v, int* sweeps, double* workspace, long long batch, int n,
                   int vectors, int group, int threads, int blocks, int max_sweeps, cudaStream_t stream) {
  const int per_block = threads / group;
  // the workspace holds one slot a block; else the groups' slots are the
  // block's dynamic shared memory
  const size_t smem = workspace != nullptr
                          ? 0
                          : static_cast<size_t>(per_block) * group_words(n, kComplex, vectors != 0) * sizeof(double);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  auto kernel = eigh_kernel<IO, kComplex>;
  // the dynamic shared memory this instance may take on each device,
  // raised as needed (an attribute is set per device)
  static size_t allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed[device] = smem;
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const IO*>(in), static_cast<IO*>(w), static_cast<IO*>(v), sweeps, workspace, batch, n, vectors,
      group, max_sweeps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128.  v may be null
// when vectors is 0; sweeps (one int a matrix: the sweeps it took, a
// diagnostic) may be null.  group: the threads of one matrix, a power of two
// up to 32 that divides threads, or threads itself (one matrix a block).
// blocks: the grid, which walks the batch.  workspace: null (the slots in
// shared memory), or blocks slots of group_words(n) float64 each, one matrix
// a block.
extern "C" int batched_eigh(const void* in, void* w, void* v, void* sweeps, void* workspace, long long batch, int n,
                            int dtype, int vectors, int group, int threads, int blocks, int max_sweeps,
                            void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (batch < 0 || n < 1 || n > kMaxN || dtype < 0 || dtype > 3 || max_sweeps < 1 || blocks < 1) return invalid;
  if (threads < 1 || threads > 1024 || threads % 32 || group < 1) return invalid;
  if (group != threads && (group > 32 || (group & (group - 1)) || threads % group)) return invalid;
  // one matrix a block sums its norm through eig: a word a warp
  if (group > 32 && threads / 32 > n + (n & 1)) return invalid;
  if (workspace != nullptr && group != threads) return invalid;
  if (vectors && v == nullptr) return invalid;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* sw = static_cast<int*>(sweeps);
  double* ws = static_cast<double*>(workspace);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float, false>(in, w, v, sw, ws, batch, n, vectors, group, threads, blocks, max_sweeps, s); break;
    case 1: err = launch<double, false>(in, w, v, sw, ws, batch, n, vectors, group, threads, blocks, max_sweeps, s); break;
    case 2: err = launch<float, true>(in, w, v, sw, ws, batch, n, vectors, group, threads, blocks, max_sweeps, s); break;
    default: err = launch<double, true>(in, w, v, sw, ws, batch, n, vectors, group, threads, blocks, max_sweeps, s); break;
  }
  return static_cast<int>(err);
}

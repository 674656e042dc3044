// FastMNMF's per-bin diagonaliser sweep and power normalisation (kernel K4).
//
// For each bin f, from K1's frames-mean covariance planes U (C^2, F, C),
// the diagonaliser Q (F, C, C), the gains g (S, F, C) and the basis
// W (S, F, K) (ops/mnmf_rows.py gives the operands' layouts):
//
//   1. for m = 0 .. C-1, from the rows as updated so far: QV = Q U_m, det QV
//      and the column q_m = QV^-1 e_m by the adjugate (Laplace expansion
//      along the first row, as ops/ip_components.py); under the one-norm
//      guard ||QV||_1 ||QV^-1||_1 < threshold, else (NaN included) the old
//      row stays; qVq = Re sum_c conj(q_c) (U_m q)_c, the denominator
//      max(sqrt(qVq), eps) and the new row conj(q_m) / denominator;
//   2. with normalize: QQsum = max(mean_m sum_c |Q_mc|^2, eps), Q /=
//      sqrt(QQsum), g /= QQsum; g_sum = max(sum_m g, eps), g /= g_sum,
//      W *= g_sum.
//
// The same operations in the same order as the plain version
// (ops/mnmf_rows.py::fastmnmf_rows_plain): complex products, quotients
// (c10::complex's scaled division) and moduli (hypot) as PyTorch computes
// them, every floor as torch.clamp (NaN passes), the guard's maxima NaN-
// propagating as torch.amax.  The compiler may contract products into FMAs.
//
// No Pallas kernel stands behind it: XLA fuses this chain in the JAX
// package's jitted step, where the PyTorch step launches some 160 kernels on
// (F,) slices, each moving a few kB.
//
// Bound: a launch reads the planes, Q, g and W once and writes Q, g and W
// once (ops/mnmf_rows.py::k4_cost): 0.59 MB at C = 2, S = 2, K = 10 and
// 2049 bins, about 0.2 us at 3.35 TB/s; the arithmetic, a few hundred FLOPs
// a bin, is far below the card's rate.  A launch's time is its latency.
//
// Design: one thread a bin, the bin's Q, U_m and intermediates in registers
// (C is a compile-time parameter, 1 to 4, so every small loop unrolls and
// every index is a constant), kThreads threads a block so that the few
// blocks spread over the SMs.  g and W are read and written once each, in
// place of the output; nothing else touches device memory.

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>
#include <utility>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxC = 4;      // ops/mnmf_rows.py::MAX_C

template <typename T>
struct Cx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ Cx<T> operator+(Cx<T> a, Cx<T> b) {
  return {a.re + b.re, a.im + b.im};
}

template <typename T>
__device__ __forceinline__ Cx<T> operator*(Cx<T> a, Cx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

template <typename T>
__device__ __forceinline__ Cx<T> neg(Cx<T> a) {
  return {-a.re, -a.im};
}

template <typename T>
__device__ __forceinline__ Cx<T> conj(Cx<T> a) {
  return {a.re, -a.im};
}

// c10::complex's operator/ (numpy's scaled division)
template <typename T>
__device__ __forceinline__ Cx<T> operator/(Cx<T> x, Cx<T> y) {
  const T a = x.re, b = x.im, c = y.re, d = y.im;
  const T abs_c = c < T(0) ? -c : c;
  const T abs_d = d < T(0) ? -d : d;
  if (abs_c >= abs_d) {
    if (abs_c == T(0) && abs_d == T(0)) return {a / abs_c, b / abs_d};
    const T rat = d / c;
    const T scl = T(1) / (c + d * rat);
    return {(a + b * rat) * scl, (b - a * rat) * scl};
  }
  const T rat = c / d;
  const T scl = T(1) / (d + c * rat);
  return {(a * rat + b) * scl, (b * rat - a) * scl};
}

template <typename T>
__device__ __forceinline__ T modulus(Cx<T> a) {
  return hypot(a.re, a.im);
}

// torch.clamp(x, min=lo): NaN passes
template <typename T>
__device__ __forceinline__ T floor_below(T x, T lo) {
  return x < lo ? lo : x;
}

// torch.amax of two: NaN wins
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// fn(std::integral_constant<int, 0>), ..., fn(std::integral_constant<int, N - 1>)
template <typename Fn, int... Is>
__device__ __forceinline__ void unroll_impl(Fn&& fn, std::integer_sequence<int, Is...>) {
  (fn(std::integral_constant<int, Is>{}), ...);
}

template <int N, typename Fn>
__device__ __forceinline__ void unroll(Fn&& fn) {
  unroll_impl(fn, std::make_integer_sequence<int, N>{});
}

__host__ __device__ constexpr int lowest(unsigned mask) {
  int i = 0;
  while (!(mask & 1u)) {
    mask >>= 1;
    ++i;
  }
  return i;
}

__host__ __device__ constexpr int count(unsigned mask) {
  int n = 0;
  for (; mask; mask >>= 1) n += static_cast<int>(mask & 1u);
  return n;
}

template <typename T, int C, unsigned Rows, unsigned Cols>
__device__ __forceinline__ Cx<T> det_minor(const Cx<T> (&M)[C][C]);

// the Laplace expansion's terms along the first row of Rows, over the
// columns Left of Cols (Pos: the position of Left's lowest in Cols)
template <typename T, int C, unsigned Rows, unsigned Cols, unsigned Left, int Pos>
__device__ __forceinline__ void det_terms(const Cx<T> (&M)[C][C], Cx<T>& total) {
  if constexpr (Left != 0u) {
    constexpr int i = lowest(Rows);
    constexpr int j = lowest(Left);
    Cx<T> term = M[i][j] * det_minor<T, C, Rows & ~(1u << i), Cols & ~(1u << j)>(M);
    if constexpr (Pos % 2 == 1) term = neg(term);
    if constexpr (Pos == 0) {
      total = term;
    } else {
      total = total + term;
    }
    det_terms<T, C, Rows, Cols, Left & ~(1u << j), Pos + 1>(M, total);
  }
}

// the determinant of M's rows Rows and columns Cols (ascending), as
// ops/ip_components.py::_det_components expands it
template <typename T, int C, unsigned Rows, unsigned Cols>
__device__ __forceinline__ Cx<T> det_minor(const Cx<T> (&M)[C][C]) {
  if constexpr (count(Rows) == 1) {
    constexpr int i = lowest(Rows);
    constexpr int j = lowest(Cols);
    return M[i][j];
  } else {
    Cx<T> total{};
    det_terms<T, C, Rows, Cols, Cols, 0>(M, total);
    return total;
  }
}

// column Col of M^-1 by the adjugate: out[i] = (-1)^(i+Col) minor(Col, i) / det
template <typename T, int C, int Col>
__device__ __forceinline__ void solve_column(const Cx<T> (&M)[C][C], Cx<T> det, Cx<T> (&out)[C]) {
  constexpr unsigned full = (1u << C) - 1u;
  unroll<C>([&](auto i_) {
    constexpr int i = decltype(i_)::value;
    Cx<T> minor;
    if constexpr (C > 1) {
      minor = det_minor<T, C, full & ~(1u << Col), full & ~(1u << i)>(M);
    } else {
      minor = Cx<T>{T(1), T(0)};
    }
    if constexpr ((i + Col) % 2 == 1) minor = neg(minor);
    out[i] = minor / det;
  });
}

// the compact plane of the real part of U[c][d], c <= d
// (ops/ip_components.py::_plane_index)
template <int C>
__host__ __device__ constexpr int re_plane(int c, int d) {
  if (c == d) return c;
  int k = 0;
  for (int a = 0; a < c; ++a) k += C - 1 - a;
  return C + 2 * (k + d - c - 1);
}

template <typename T, int C, bool kOneNorm, bool kNormalize>
__global__ void __launch_bounds__(kThreads)
    fastmnmf_rows_kernel(const T* __restrict__ planes, const Cx<T>* __restrict__ q_in, const T* __restrict__ g_in,
                         const T* __restrict__ w_in, Cx<T>* __restrict__ q_out, T* __restrict__ g_out,
                         T* __restrict__ w_out, int S, int K, int F, T eps, T threshold) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  Cx<T> Q[C][C];
  unroll<C * C>([&](auto e_) {
    constexpr int e = decltype(e_)::value;
    Q[e / C][e % C] = q_in[static_cast<long long>(f) * C * C + e];
  });

  unroll<C>([&](auto m_) {
    constexpr int m = decltype(m_)::value;
    // U_m (Hermitian) from its compact planes
    Cx<T> U[C][C];
    unroll<C * C>([&](auto e_) {
      constexpr int c = decltype(e_)::value / C;
      constexpr int d = decltype(e_)::value % C;
      constexpr int lo = c < d ? c : d;
      constexpr int hi = c < d ? d : c;
      constexpr int plane = re_plane<C>(lo, hi);
      const T re = planes[(static_cast<long long>(plane) * F + f) * C + m];
      if constexpr (c == d) {
        U[c][d] = {re, T(0)};
      } else {
        const T im = planes[(static_cast<long long>(plane + 1) * F + f) * C + m];
        U[c][d] = {re, c < d ? im : -im};
      }
    });
    Cx<T> QV[C][C];
    unroll<C * C>([&](auto e_) {
      constexpr int i = decltype(e_)::value / C;
      constexpr int j = decltype(e_)::value % C;
      Cx<T> acc = Q[i][0] * U[0][j];
      unroll<C - 1>([&](auto c_) {
        constexpr int c = decltype(c_)::value + 1;
        acc = acc + Q[i][c] * U[c][j];
      });
      QV[i][j] = acc;
    });
    constexpr unsigned full = (1u << C) - 1u;
    const Cx<T> det = det_minor<T, C, full, full>(QV);
    Cx<T> q[C];
    solve_column<T, C, m>(QV, det, q);

    bool ok = true;
    if constexpr (kOneNorm) {
      T norm = T(0), inv_norm = T(0);
      unroll<C>([&](auto j_) {
        constexpr int j = decltype(j_)::value;
        T col = modulus(QV[0][j]);
        unroll<C - 1>([&](auto i_) { col = col + modulus(QV[decltype(i_)::value + 1][j]); });
        norm = j == 0 ? col : max_nan(norm, col);
        Cx<T> inv[C];
        solve_column<T, C, j>(QV, det, inv);
        T inv_col = modulus(inv[0]);
        unroll<C - 1>([&](auto i_) { inv_col = inv_col + modulus(inv[decltype(i_)::value + 1]); });
        inv_norm = j == 0 ? inv_col : max_nan(inv_norm, inv_col);
      });
      ok = norm * inv_norm < threshold;
    }

    Cx<T> Uq[C];
    unroll<C>([&](auto c_) {
      constexpr int c = decltype(c_)::value;
      Cx<T> acc = U[c][0] * q[0];
      unroll<C - 1>([&](auto d_) {
        constexpr int d = decltype(d_)::value + 1;
        acc = acc + U[c][d] * q[d];
      });
      Uq[c] = acc;
    });
    T qVq = (conj(q[0]) * Uq[0]).re;
    unroll<C - 1>([&](auto c_) {
      constexpr int c = decltype(c_)::value + 1;
      qVq = qVq + (conj(q[c]) * Uq[c]).re;
    });
    const Cx<T> denominator{floor_below(sqrt(qVq), eps), T(0)};
    if (ok) {
      unroll<C>([&](auto c_) {
        constexpr int c = decltype(c_)::value;
        Q[m][c] = conj(q[c]) / denominator;
      });
    }
  });

  if constexpr (kNormalize) {
    T qq = T(0);
    unroll<C>([&](auto m_) {
      constexpr int m = decltype(m_)::value;
      T row = (Q[m][0] * conj(Q[m][0])).re;
      unroll<C - 1>([&](auto c_) {
        constexpr int c = decltype(c_)::value + 1;
        row = row + (Q[m][c] * conj(Q[m][c])).re;
      });
      qq = m == 0 ? row : qq + row;
    });
    const T qq_sum = floor_below(qq / T(C), eps);
    const Cx<T> scale{sqrt(qq_sum), T(0)};
    unroll<C * C>([&](auto e_) {
      constexpr int e = decltype(e_)::value;
      q_out[static_cast<long long>(f) * C * C + e] = Q[e / C][e % C] / scale;
    });
    for (int s = 0; s < S; ++s) {
      const long long base = static_cast<long long>(s) * F + f;
      T gs[C];
      unroll<C>([&](auto m_) {
        constexpr int m = decltype(m_)::value;
        gs[m] = g_in[base * C + m] / qq_sum;
      });
      T g_sum = gs[0];
      unroll<C - 1>([&](auto m_) { g_sum = g_sum + gs[decltype(m_)::value + 1]; });
      g_sum = floor_below(g_sum, eps);
      unroll<C>([&](auto m_) {
        constexpr int m = decltype(m_)::value;
        g_out[base * C + m] = gs[m] / g_sum;
      });
      for (int k = 0; k < K; ++k) w_out[base * K + k] = w_in[base * K + k] * g_sum;
    }
  } else {
    unroll<C * C>([&](auto e_) {
      constexpr int e = decltype(e_)::value;
      q_out[static_cast<long long>(f) * C * C + e] = Q[e / C][e % C];
    });
  }
}

template <typename T, int C>
cudaError_t launch_c(const void* planes, const void* q_in, const void* g_in, const void* w_in, void* q_out,
                     void* g_out, void* w_out, int S, int K, int F, int guard, int normalize, double eps,
                     double threshold, cudaStream_t stream) {
  const dim3 grid((F + kThreads - 1) / kThreads);
  auto* p = static_cast<const T*>(planes);
  auto* qi = static_cast<const Cx<T>*>(q_in);
  auto* gi = static_cast<const T*>(g_in);
  auto* wi = static_cast<const T*>(w_in);
  auto* qo = static_cast<Cx<T>*>(q_out);
  auto* go = static_cast<T*>(g_out);
  auto* wo = static_cast<T*>(w_out);
  const T e = static_cast<T>(eps), t = static_cast<T>(threshold);
  if (guard == 0 && normalize) {
    fastmnmf_rows_kernel<T, C, true, true><<<grid, kThreads, 0, stream>>>(p, qi, gi, wi, qo, go, wo, S, K, F, e, t);
  } else if (guard == 0) {
    fastmnmf_rows_kernel<T, C, true, false><<<grid, kThreads, 0, stream>>>(p, qi, gi, wi, qo, go, wo, S, K, F, e, t);
  } else if (normalize) {
    fastmnmf_rows_kernel<T, C, false, true><<<grid, kThreads, 0, stream>>>(p, qi, gi, wi, qo, go, wo, S, K, F, e, t);
  } else {
    fastmnmf_rows_kernel<T, C, false, false><<<grid, kThreads, 0, stream>>>(p, qi, gi, wi, qo, go, wo, S, K, F, e, t);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* planes, const void* q_in, const void* g_in, const void* w_in, void* q_out, void* g_out,
                   void* w_out, int C, int S, int K, int F, int guard, int normalize, double eps, double threshold,
                   cudaStream_t stream) {
  switch (C) {
    case 1:
      return launch_c<T, 1>(planes, q_in, g_in, w_in, q_out, g_out, w_out, S, K, F, guard, normalize, eps, threshold,
                             stream);
    case 2:
      return launch_c<T, 2>(planes, q_in, g_in, w_in, q_out, g_out, w_out, S, K, F, guard, normalize, eps, threshold,
                             stream);
    case 3:
      return launch_c<T, 3>(planes, q_in, g_in, w_in, q_out, g_out, w_out, S, K, F, guard, normalize, eps, threshold,
                             stream);
    default:
      return launch_c<T, 4>(planes, q_in, g_in, w_in, q_out, g_out, w_out, S, K, F, guard, normalize, eps, threshold,
                             stream);
  }
}

}  // namespace

// dtype: 0 complex64 (float32 planes, gains, basis), 1 complex128 (float64);
// guard: 0 one_norm, 1 none; g_out and w_out are written only with normalize.
// Returns a CUDA error code, 0 on success.
extern "C" int fastmnmf_rows(const void* planes, const void* q_in, const void* g_in, const void* w_in, void* q_out,
                             void* g_out, void* w_out, int dtype, int C, int S, int K, int F, int guard,
                             int normalize, double eps, double threshold, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (dtype < 0 || dtype > 1 || C < 1 || C > kMaxC || S < 1 || K < 1 || F < 0) return invalid;
  if (guard < 0 || guard > 1) return invalid;
  if (normalize && (g_out == nullptr || w_out == nullptr)) return invalid;
  if (F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(planes, q_in, g_in, w_in, q_out, g_out, w_out, C, S, K, F, guard, normalize, eps, threshold, s);
  } else {
    err = launch<double>(planes, q_in, g_in, w_in, q_out, g_out, w_out, C, S, K, F, guard, normalize, eps, threshold,
                         s);
  }
  return static_cast<int>(err);
}

// Fused Crank-Nicolson march of a barrier batch with constant-coefficient
// cyclic reduction, for Hopper (sm_90a).
//
// Replaces the TPU kernel finite_difference_tpu/models/pde/pallas_cr.py
// `_cr_kernel` (launched by `cn_barrier_solve_pallas_cr`). Its plain
// PyTorch version is finite_difference_tpu_torch/models/pde/cr.py
// `cr_march_reference`; the prep is that of fused.py with the solver data
// the (2, B, n_levels, 16) per-level class scalars of cr.cr_level_coeffs
// (slots cr._SLOTS), one trade's levels contiguous.
//
// One launch runs the whole march. Per step: the explicit rhs of the
// n = N-2 interior rows (n a power of two), the forward reduction (at each
// level the evens go on a stack and the odds become d_k = o_k - alpha_k e_k
// - gamma_k e_{k+1}), the 1x1 pivot b_final, back-substitution (x_even_k =
// (e_k - ae_k x_{k-1} - ce_k x_k) / be_k, interleaved with the odds), then
// the edges and the knock-out projection to the rebate PV on monitor steps.
// Each level's coefficient is one of three scalars: `last` at the level's
// last row, else `first` at its row 0, else `interior`. Every row keeps the
// plain version's arithmetic and order; only the mapping is this card's.
//
// Mapping. One warp per trade, four trades per block (fewer where a
// block's shared memory would pass 227 KB). Every synchronisation inside a
// trade is a __syncwarp or a shuffle: no block barrier runs inside a step.
// Levels with more than 32 rows run from shared memory: a lane loops over
// its share of the level's pairs, kU = 4 iterations at a time with all
// their loads before their stores, so that their latencies overlap; level
// l reads its buffer and writes level l+1's, its evens stay where they are
// (in place of a stack), and back-substitution overwrites each even/odd
// pair with the level's solution. The rhs is fused into level 0: a lane
// reads its pair of value rows, the odd row below and the pair above, and
// forms e, o and the next pair's e in registers; level 0 then writes e
// into the even slot of the value row (the odd slot keeps its value, which
// the lane above reads), after a __syncwarp that ends the batch's reads.
// The last six levels (32 rows or fewer, level log2 n - 6 on) run in
// registers: lane j keeps d_j, the next level gathers its pair by
// shuffles, and each level's evens stay in registers for
// back-substitution, which hands its solution down the same way. Each
// level's class scalars are read into registers once per level. Pairs are
// read and written as float2/double2 (a lane's pair is 8 or 16 aligned
// bytes). The last back-substitution level writes the value row with the
// knock-out projection: one pass over the row per step.
// A trade's shared memory (kernels.cr_smem_bytes, launch rule
// kernels.cr_block): the interior value row (n values; the two edge values
// live in registers), the buffers of the shared levels after the first
// (n - 64 values), both theta sets' level scalars (32 per level), and per
// set the reciprocals of each level's three be classes and of b_final:
// 9.24 KiB at N = 1026 in f32 (6 blocks, 24 trades per SM; 2 waves for
// B = 4096 on 132 SMs) and 18.5 KiB in f64.
//
// Division. Back-substitution keeps the plain version's true division,
// correctly rounded, but not the hardware's: its range check is a branch
// per row that keeps the compiler from overlapping the rows. div_fast
// divides by a
// reciprocal computed once per launch and one exact correction (Markstein),
// with no branch; the rare rows outside its range go to the hardware
// division behind one warp vote.
//
// Bound. About 10 flops per interior node and step (rhs 5, and the 5 of a
// tridiagonal solve), as for the scan march: 0.32 ms at B=4096, N=1026,
// 512 steps, f32, against about 0.03 ms of bytes, so operations bound it.
// Cyclic reduction itself spends about 4 flops per row eliminated and 5
// per row substituted (the division now a reciprocal, a multiply and two
// FMAs), overhead of the method, and the fused rhs forms each even row
// twice. What limits this design is latency (chip_smoke.py times a step
// against the trades per SM and the grid): 24 warps per SM hide only part
// of it, and the 4096 trades take 2 waves. The first port (one
// block of n/2 threads per trade, 23 block barriers per step) took 53 ms
// per march at that size on one NVIDIA H100 80GB HBM3 (700 W), this design
// 11.9 ms (PERF.md).
//
// Precise math only: expf/exp, correctly rounded divisions, no
// --use_fast_math. nvcc contracts a*b+c into FMA by default, so f32 results
// differ from the plain version at the rounding level.

#include <cuda_runtime.h>

namespace {

constexpr int kTradeCols = 9;  // fused.TRADE_COLS
constexpr int kCoefCols = 5;   // fused.COEF_COLS
constexpr int kSlots = 16;     // cr.N_SLOTS
// first-class slot of each coefficient in cr._SLOTS (interior +1, last +2)
constexpr int kAlpha = 0, kGamma = 3, kAe = 6, kBe = 9, kCe = 12, kBFinal = 15;
constexpr int kTradesPerBlock = 4;
constexpr int kDeep = 6;  // levels of 32 rows or fewer: log2 n - 6 and on
constexpr int kU = 4;     // iterations of a shared level whose loads go first
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// pair k (rows 2k, 2k+1) of a buffer that starts on a pair boundary
template <typename T>
__device__ __forceinline__ typename Pair<T>::type& pair(T* buf, int k) {
  return reinterpret_cast<typename Pair<T>::type*>(buf)[k];
}

template <typename T>
__device__ __forceinline__ const typename Pair<T>::type& pair(const T* buf, int k) {
  return reinterpret_cast<const typename Pair<T>::type*>(buf)[k];
}

// a level's three class scalars of one coefficient, in registers
template <typename T>
struct Cls {
  T first, interior, last;
  // row k's of a level with `rows` rows (cr.class_vec)
  __device__ __forceinline__ T at(int k, int rows) const {
    return k == rows - 1 ? last : (k == 0 ? first : interior);
  }
};

template <typename T>
__device__ __forceinline__ Cls<T> load_cls(const T* slot) {
  return {slot[0], slot[1], slot[2]};
}

// a step's explicit coefficients and edge values
template <typename T>
struct Rhs {
  T bl, bc, bu, al, au;
  T v_lo, v_hi;    // the edges the step starts from
  T v_min, v_max;  // the step's Dirichlet values
};

// the explicit rhs (fused.explicit_rhs) of rows 2j, 2j+1 and 2j+2 from the
// value row x around pair j, the edges beyond it; x1 is row 2j+1's value
template <typename T>
__device__ __forceinline__ void fused_rhs(const T* x, int j, int half, const Rhs<T>& c, T& e, T& o,
                                          T& e_up, T& x1) {
  const auto p = pair(x, j);
  x1 = p.y;
  const T xm = j > 0 ? x[2 * j - 1] : c.v_lo;
  T x2, x3 = T(0);
  if (j < half - 1) {
    const auto q = pair(x, j + 1);
    x2 = q.x;
    x3 = q.y;
  } else {
    x2 = c.v_hi;
  }
  e = c.bl * xm + c.bc * p.x + c.bu * p.y;
  o = c.bl * p.x + c.bc * p.y + c.bu * x2;
  if (j == 0) e = e - c.al * c.v_min;
  if (j == half - 1) o = o - c.au * c.v_max;
  e_up = j < half - 1 ? c.bl * p.y + c.bc * x2 + c.bu * x3 : T(0);
}

// the first level of 32 rows or fewer: it and those after run in registers
__host__ __device__ inline int first_register_level(int n_levels) {
  return n_levels > kDeep ? n_levels - kDeep : 0;
}

// values of one trade's shared memory (kernels.cr_smem_bytes): the value
// row, the buffers of levels 1..first_register_level, both sets' level
// scalars, and per set the reciprocals of each level's be classes and of
// b_final
__host__ __device__ inline int trade_smem_elems(int n, int n_levels) {
  return 2 * n - (n >> first_register_level(n_levels)) + 2 * n_levels * kSlots +
         2 * (3 * n_levels + 1);
}

// the range of |a| and of |b| where div_fast's quotient is the correctly
// rounded a / b (its intermediates stay normal and finite), the power of
// two that brings a smaller |a| into it, and half the spacing of the
// subnormal numbers scaled by that power
template <typename T> struct DivRange;
template <> struct DivRange<float> {
  static constexpr float lo = 0x1p-90f, hi = 0x1p90f, b_lo = 0x1p-20f, b_hi = 0x1p20f;
  static constexpr float up = 0x1p100f, down = 0x1p-100f, half_gap = 0x1p-50f;
};
template <> struct DivRange<double> {
  static constexpr double lo = 0x1p-900, hi = 0x1p900, b_lo = 0x1p-20, b_hi = 0x1p20;
  static constexpr double up = 0x1p1000, down = 0x1p-1000, half_gap = 0x1p-75;
};

// x moved by d units in the last place (within one binade, away from 0 for
// d of x's sign)
__device__ __forceinline__ float ulp_step(float x, int d) { return __int_as_float(__float_as_int(x) + d); }
__device__ __forceinline__ double ulp_step(double x, int d) {
  return __longlong_as_double(__double_as_longlong(x) + d);
}

// the reciprocal div_fast takes for divisor b: RN(1/b), or 0 where b is
// outside the range
template <typename T>
__device__ __forceinline__ T div_reciprocal(T b) {
  const T m = b < T(0) ? -b : b;
  return m >= DivRange<T>::b_lo && m <= DivRange<T>::b_hi ? T(1) / b : T(0);
}

// a / b, correctly rounded, from y = div_reciprocal(b) and with no branch:
// q0 = RN(a y) is within an ulp of a / b, and one correction with the
// exact remainder fma(-b, q0, a) rounds it correctly (Markstein's theorem)
// while the intermediates stay in the normal range. A smaller |a|
// (subnormal ones too) is scaled up by a power of two first and the
// quotient scaled back, which rounds once more where the quotient is
// subnormal: so where the scaled quotient lies on a midpoint of the
// subnormal grid but the exact one does not, it first steps one ulp to the
// exact one's side (the sign of the remainder). `exact` is false only for
// |a| or |b| out of range, rows a caller divides in hardware behind one
// warp vote: the hardware division checks its range by a branch per row,
// which keeps the compiler from overlapping these loops' rows.
template <typename T>
__device__ __forceinline__ T div_fast(T a, T b, T y, bool& exact) {
  using R = DivRange<T>;
  const T m = a < T(0) ? -a : a;
  const bool small = m < R::lo;
  const T as = small ? a * R::up : a;
  const T q0 = as * y;
  T qs = fma(y, fma(-b, q0, as), q0);
  const T rs = fma(-b, qs, as);
  const T gap = qs - qs * R::down * R::up;
  const bool tie = small && (gap == R::half_gap || gap == -R::half_gap) && rs != T(0);
  const bool up = (rs > T(0)) == (b > T(0));
  qs = tie ? ulp_step(qs, up == (qs > T(0)) ? 1 : -1) : qs;
  exact = y != T(0) && m <= R::hi;
  return small ? qs * R::down : qs;
}

// blocks per SM the launch bounds ask registers for: what shared memory
// allows at N=1026 (kernels.cr_block), 6 in f32 and 3 in f64
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 3;

template <typename T>
__global__ void __launch_bounds__(32 * kTradesPerBlock, kMinBlocks<T>)
cr_march_kernel(
    const T* __restrict__ trade,  // (B, 9)
    const T* __restrict__ coef,   // (2, B, 5) bl, bc, bu, al, au per set
    const T* __restrict__ lvl,    // (2, B, n_levels, 16)
    const T* __restrict__ omask,  // (B, N)
    const T* __restrict__ tau,    // (B, n_steps)
    const T* __restrict__ mon,    // (B, n_steps)
    const T* __restrict__ v_in,   // (B, N)
    T* __restrict__ v_out,        // (B, N)
    int B, int N, int n_levels, int n_steps, int n_rann) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // ragged last block: whole warps drop out
  const int n = N - 2;
  T* __restrict__ s_x = reinterpret_cast<T*>(smem_raw) + (size_t)warp * trade_smem_elems(n, n_levels);
  // levels l_deep.. have 32 rows or fewer and run in registers
  const int l_deep = first_register_level(n_levels);
  const int n_deep = n_levels - l_deep;
  T* __restrict__ s_red = s_x + n;  // the buffers of levels 1..l_deep
  T* __restrict__ s_lvl = s_red + (n - (n >> l_deep));  // 2 * n_levels * 16
  const int per_set = n_levels * kSlots;
  // per set: 1/be of each level's three classes, then 1/b_final
  T* __restrict__ s_rcp = s_lvl + 2 * per_set;
  const int rcp_set = 3 * n_levels + 1;

  const T* tr = trade + (size_t)b * kTradeCols;
  const T strike = tr[0], r = tr[2], growth_rate = tr[3], rebate = tr[4];
  const T rebate_rate = tr[6], s_min = tr[7], s_max = tr[8];
  const bool is_call = tr[1] != T(0), at_hit = tr[5] != T(0);
  const T* c0 = coef + (size_t)b * kCoefCols;
  const T* c1 = coef + ((size_t)B + b) * kCoefCols;
  const size_t base = (size_t)b * N;
  const T* __restrict__ om = omask + base;
  const T* __restrict__ tau_b = tau + (size_t)b * n_steps;
  const T* __restrict__ mon_b = mon + (size_t)b * n_steps;

  for (int i = lane; i < n; i += 32) s_x[i] = v_in[base + 1 + i];
  for (int i = lane; i < 2 * per_set; i += 32) {
    const int set = i / per_set;
    s_lvl[i] = lvl[((size_t)set * B + b) * per_set + (i - set * per_set)];
  }
  T v_lo = v_in[base], v_hi = v_in[base + N - 1];  // the edge values
  __syncwarp();
  for (int i = lane; i < 2 * rcp_set; i += 32) {
    const int set = i / rcp_set, c = i - set * rcp_set;
    const T* lv = s_lvl + set * per_set;
    s_rcp[i] = div_reciprocal(c < 3 * n_levels ? lv[(c / 3) * kSlots + kBe + c % 3] : lv[kBFinal]);
  }
  __syncwarp();

  for (int k = 0; k < n_steps; ++k) {
    const bool rann = k < n_rann;
    const T* cf = rann ? c0 : c1;
    const T bl = cf[0], bc = cf[1], bu = cf[2], al = cf[3], au = cf[4];
    const T* L = s_lvl + (rann ? 0 : per_set);
    const T* R = s_rcp + (rann ? 0 : rcp_set);
    const T t = tau_b[k];
    const bool mon_k = mon_b[k] != T(0);
    const T growth = exp_(growth_rate * t);
    const T disc = exp_(-r * t);
    const T v_min = is_call ? T(0) : strike * disc - s_min * growth;
    const T v_max = is_call ? s_max * growth - strike * disc : T(0);
    const T rebate_pv = at_hit ? rebate : rebate * exp_(-rebate_rate * t);

    const Rhs<T> rc{bl, bc, bu, al, au, v_lo, v_hi, v_min, v_max};
    // the knock-out projection of interior rows 2j, 2j+1 (grid nodes 2j+1, 2j+2)
    auto knock_out = [&](T& xe, T& xo, int j) {
      if (mon_k) {
        if (om[2 * j + 1] != T(0)) xe = rebate_pv;
        if (om[2 * j + 2] != T(0)) xo = rebate_pv;
      }
    };

    // forward reduction, shared levels: level l reads src (m = n >> l rows)
    // and writes dst (m/2 rows), the buffer of level l+1; kU iterations'
    // loads before their stores
    T* src = s_x;
    T* dst = s_red;
    int m = n;
    for (int lev = 0; lev < l_deep; ++lev) {
      const int half = m >> 1;
      const Cls<T> alpha = load_cls(L + lev * kSlots + kAlpha);
      const Cls<T> gamma = load_cls(L + lev * kSlots + kGamma);
      for (int base = 0; base < half; base += 32 * kU) {
        T d[kU], ev[kU], x1[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = base + 32 * u + lane;
          T e = T(0), o = T(0), e_up = T(0);
          x1[u] = T(0);
          if (j < half) {
            if (lev == 0) {
              fused_rhs(src, j, half, rc, e, o, e_up, x1[u]);
            } else {
              const auto p = pair(src, j);
              e = p.x;
              o = p.y;
              if (j < half - 1) e_up = src[2 * j + 2];
            }
          }
          d[u] = o - alpha.at(j, half) * e - gamma.at(j, half) * e_up;
          ev[u] = e;
        }
        // level 0 overwrites the rows it read: end the batch's reads
        if (lev == 0) __syncwarp();
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = base + 32 * u + lane;
          if (j < half) {
            if (lev == 0) pair(src, j) = {ev[u], x1[u]};
            dst[j] = d[u];
          }
        }
      }
      __syncwarp();
      src = dst;
      dst += half;
      m = half;
    }

    // forward reduction, register levels (32 rows or fewer): lane j keeps
    // its d_j, and the next level gathers its pair by shuffles; the evens
    // stay in registers for back-substitution
    T* const deep_buf = src;  // the first register level's input
    T evs[kDeep];
    T dk = T(0);
#pragma unroll
    for (int q = 0; q < kDeep; ++q) {
      if (q < n_deep) {
        const int lev = l_deep + q;
        const int half = m >> 1;
        const Cls<T> alpha = load_cls(L + lev * kSlots + kAlpha);
        const Cls<T> gamma = load_cls(L + lev * kSlots + kGamma);
        const int j = lane;
        T e = T(0), o = T(0), e_up = T(0);
        if (q == 0) {
          if (j < half) {
            if (lev == 0) {
              T x1;
              fused_rhs(src, j, half, rc, e, o, e_up, x1);
            } else {
              const auto p = pair(src, j);
              e = p.x;
              o = p.y;
              if (j < half - 1) e_up = src[2 * j + 2];
            }
          }
        } else {
          e = __shfl_sync(kFull, dk, 2 * j);
          o = __shfl_sync(kFull, dk, 2 * j + 1);
          const T up = __shfl_sync(kFull, dk, 2 * j + 2);
          e_up = j < half - 1 ? up : T(0);
        }
        T d = o - alpha.at(j, half) * e - gamma.at(j, half) * e_up;
        if (lev == n_levels - 1) {  // the 1x1 pivot, on lane 0
          bool exact;
          const T q1 = div_fast(d, L[kBFinal], R[3 * n_levels], exact);
          const bool redo = !exact && j == 0;
          d = __any_sync(kFull, redo) && redo ? d / L[kBFinal] : q1;
        }
        evs[q] = e;
        dk = d;
        m = half;
      }
    }

    // back-substitution, register levels: lane j holds x_{l+1}[j] (from
    // the pair the level above left on lane j/2) and leaves level l's pair
    // x_l[2j], x_l[2j+1]
    T xe_p = T(0), xo_p = T(0);
#pragma unroll
    for (int q = kDeep - 1; q >= 0; --q) {
      if (q < n_deep) {
        const int lev = l_deep + q;
        const int half = n >> (lev + 1);
        const Cls<T> ae = load_cls(L + lev * kSlots + kAe);
        const Cls<T> be = load_cls(L + lev * kSlots + kBe);
        const Cls<T> ce = load_cls(L + lev * kSlots + kCe);
        const Cls<T> rbe = load_cls(R + 3 * lev);
        const int j = lane;
        T xv = dk;  // the 1x1 system's solution at the last level (lane 0)
        if (lev < n_levels - 1) {
          const T a = __shfl_sync(kFull, xe_p, j >> 1);
          const T b = __shfl_sync(kFull, xo_p, j >> 1);
          xv = (j & 1) ? b : a;
        }
        const T xl = __shfl_up_sync(kFull, xv, 1);
        const T x_lo = j > 0 ? xl : T(0);
        const T num = evs[q] - ae.at(j, half) * x_lo - ce.at(j, half) * xv;
        bool exact;
        T xe = div_fast(num, be.at(j, half), rbe.at(j, half), exact);
        const bool redo = !exact && j < half;
        if (__any_sync(kFull, redo) && redo) xe = num / be.at(j, half);
        xe_p = xe;
        xo_p = xv;
      }
    }
    {
      const int half = n >> (l_deep + 1);
      if (l_deep == 0) {
        __syncwarp();  // the fused rhs's reads of the value row are done
        if (lane < half) knock_out(xe_p, xo_p, lane);
      }
      if (lane < half) pair(deep_buf, lane) = {xe_p, xo_p};
      __syncwarp();
    }

    // back-substitution, shared levels: level l's solution from level
    // l+1's (x) and the evens in place; level 0 writes the value row,
    // knock-out projection included
    T* x = deep_buf;
    for (int lev = l_deep - 1; lev >= 0; --lev) {
      const int half = n >> (lev + 1);
      T* out = lev == 0 ? s_x : x - 2 * half;
      const Cls<T> ae = load_cls(L + lev * kSlots + kAe);
      const Cls<T> be = load_cls(L + lev * kSlots + kBe);
      const Cls<T> ce = load_cls(L + lev * kSlots + kCe);
      const Cls<T> rbe = load_cls(R + 3 * lev);
      for (int base = 0; base < half; base += 32 * kU) {
        T xe[kU], xo[kU], num[kU];
        bool redo[kU], any_redo = false;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = base + 32 * u + lane;
          xe[u] = xo[u] = num[u] = T(0);
          redo[u] = false;
          if (j < half) {
            const T xv = x[j];
            const T x_lo = j > 0 ? x[j - 1] : T(0);
            const T e = pair(out, j).x;
            num[u] = e - ae.at(j, half) * x_lo - ce.at(j, half) * xv;
            bool exact;
            xe[u] = div_fast(num[u], be.at(j, half), rbe.at(j, half), exact);
            xo[u] = xv;
            redo[u] = !exact;
            any_redo |= !exact;
          }
        }
        if (__any_sync(kFull, any_redo)) {
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int j = base + 32 * u + lane;
            if (redo[u]) xe[u] = num[u] / be.at(j, half);
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = base + 32 * u + lane;
          if (j < half) {
            if (lev == 0) knock_out(xe[u], xo[u], j);
            pair(out, j) = {xe[u], xo[u]};
          }
        }
      }
      __syncwarp();
      x = out;
    }
    v_lo = (mon_k && om[0] != T(0)) ? rebate_pv : v_min;
    v_hi = (mon_k && om[N - 1] != T(0)) ? rebate_pv : v_max;
  }

  for (int i = lane; i < n; i += 32) v_out[base + 1 + i] = s_x[i];
  if (lane == 0) {
    v_out[base] = v_lo;
    v_out[base + N - 1] = v_hi;
  }
}

// trades per block and dynamic shared memory of a launch (kernels.cr_block);
// false if even one trade per block does not fit
template <typename T>
bool config(int n, int n_levels, int* tpb, size_t* smem) {
  const size_t per_trade = (size_t)trade_smem_elems(n, n_levels) * sizeof(T);
  int t = kTradesPerBlock;
  while (t > 1 && t * per_trade > kMaxSmem) t /= 2;
  *tpb = t;
  *smem = t * per_trade;
  return *smem <= kMaxSmem;
}

template <typename T>
cudaError_t opt_in(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(cr_march_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline bool valid_shape(int N, int n_levels) {
  const int n = N - 2;
  return n >= 2 && (n & (n - 1)) == 0 && (1 << n_levels) == n;
}

template <typename T>
int launch(const void* trade, const void* coef, const void* lvl, const void* omask,
           const void* tau, const void* mon, const void* v_in, void* v_out, int B, int N,
           int n_levels, int n_steps, int n_rann, void* stream) {
  if (B <= 0 || !valid_shape(N, n_levels) || n_steps < 0 || n_rann < 0 || n_rann > n_steps)
    return (int)cudaErrorInvalidValue;
  int tpb;
  size_t smem;
  if (!config<T>(N - 2, n_levels, &tpb, &smem)) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in<T>(smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + tpb - 1) / tpb);
  cr_march_kernel<T><<<grid, 32 * tpb, smem, (cudaStream_t)stream>>>(
      (const T*)trade, (const T*)coef, (const T*)lvl, (const T*)omask, (const T*)tau,
      (const T*)mon, (const T*)v_in, (T*)v_out, B, N, n_levels, n_steps, n_rann);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int N, int n_levels, int* trades_per_sm) {
  if (!valid_shape(N, n_levels)) return (int)cudaErrorInvalidValue;
  int tpb;
  size_t smem;
  if (!config<T>(N - 2, n_levels, &tpb, &smem)) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in<T>(smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cr_march_kernel<T>, 32 * tpb, smem);
  if (e != cudaSuccess) return (int)e;
  *trades_per_sm = blocks * tpb;
  return 0;
}

}  // namespace

#define CR_MARCH_ARGS                                                        \
  const void *trade, const void *coef, const void *lvl, const void *omask, \
      const void *tau, const void *mon, const void *v_in, void *v_out,     \
      int B, int N, int n_levels, int n_steps, int n_rann, void *stream
#define CR_MARCH_CALL \
  trade, coef, lvl, omask, tau, mon, v_in, v_out, B, N, n_levels, n_steps, n_rann, stream

extern "C" {

int cr_march_f32(CR_MARCH_ARGS) { return launch<float>(CR_MARCH_CALL); }

int cr_march_f64(CR_MARCH_ARGS) { return launch<double>(CR_MARCH_CALL); }

// trades resident per SM for a launch at N nodes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times trades per block)
int cr_march_occupancy(int f64, int N, int n_levels, int* trades_per_sm) {
  return f64 ? occupancy<double>(N, n_levels, trades_per_sm)
             : occupancy<float>(N, n_levels, trades_per_sm);
}

const char* cr_march_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

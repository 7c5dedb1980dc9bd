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
// last row, else `first` at its row 0, else `interior`.
//
// Mapping. One block per trade, n/2 threads (at least 32, at most 1024;
// each loops over the rows or pairs of a stage). Shared memory holds the
// value row (N), two ping-pong buffers for the reduced right-hand sides
// (n and n/2), the stack of every level's evens (n) and both theta sets'
// level scalars: (N + 2.5 n) values plus 32 per level, about 16 KB at
// N = 1026 in f32 and 31 KB in f64. Each level reads one buffer and writes
// the other, so a stage takes one block barrier: 2 log2 n + 3 per step.
// The deep levels leave most threads idle (level l has n / 2^(l+1) active
// rows): the price of this simple mapping, measured in chip_smoke.py.
//
// Bound. About 10 flops per interior node and step (rhs 5, and the 5 of a
// tridiagonal solve), as for the scan march: 0.32 ms at B=4096, N=1026,
// 512 steps, f32, against about 0.03 ms of bytes, so operations bound it.
// Cyclic reduction itself spends about 4 flops per row eliminated and 5
// (with a division) per row substituted, overhead of the method. The
// barriers and the idle deep levels make latency the likely limiter.
// chip_smoke.py measured 53 ms per march at that size on one NVIDIA H100
// 80GB HBM3 (700 W), 167x the bound; what limits it is not measured.
//
// Precise math only: expf/exp, true divisions, no --use_fast_math. nvcc
// contracts a*b+c into FMA by default, so f32 results differ from the
// plain version at the rounding level.

#include <cuda_runtime.h>

namespace {

constexpr int kTradeCols = 9;  // fused.TRADE_COLS
constexpr int kCoefCols = 5;   // fused.COEF_COLS
constexpr int kSlots = 16;     // cr.N_SLOTS
// first-class slot of each coefficient in cr._SLOTS (interior +1, last +2)
constexpr int kAlpha = 0, kGamma = 3, kAe = 6, kBe = 9, kCe = 12, kBFinal = 15;
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// the class scalar of row k of a level with `rows` rows (cr.class_vec)
template <typename T>
__device__ __forceinline__ T cls(const T* lv, int slot, int k, int rows) {
  return k == rows - 1 ? lv[slot + 2] : (k == 0 ? lv[slot] : lv[slot + 1]);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
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
  const int n = N - 2;
  T* s_v = reinterpret_cast<T*>(smem_raw);  // N
  T* s_ping = s_v + N;                      // n
  T* s_pong = s_ping + n;                   // n / 2
  T* s_stack = s_pong + n / 2;              // n (n - 1 used)
  T* s_lvl = s_stack + n;                   // 2 * n_levels * 16
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int per_set = n_levels * kSlots;

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

  for (int g = tid; g < N; g += nt) s_v[g] = v_in[base + g];
  for (int i = tid; i < 2 * per_set; i += nt) {
    const int set = i / per_set;
    s_lvl[i] = lvl[((size_t)set * B + b) * per_set + (i - set * per_set)];
  }
  __syncthreads();

  for (int k = 0; k < n_steps; ++k) {
    const bool rann = k < n_rann;
    const T* cf = rann ? c0 : c1;
    const T bl = cf[0], bc = cf[1], bu = cf[2], al = cf[3], au = cf[4];
    const T* L = s_lvl + (rann ? 0 : per_set);
    const T t = tau_b[k];
    const T growth = exp_(growth_rate * t);
    const T disc = exp_(-r * t);
    const T v_min = is_call ? T(0) : strike * disc - s_min * growth;
    const T v_max = is_call ? s_max * growth - strike * disc : T(0);
    const bool mon_k = mon_b[k] != T(0);
    const T rebate_pv = at_hit ? rebate : rebate * exp_(-rebate_rate * t);

    // right-hand side of the interior rows
    for (int i = tid; i < n; i += nt) {
      const int g = i + 1;
      T rhs = bl * s_v[g - 1] + bc * s_v[g] + bu * s_v[g + 1];
      if (g == 1) rhs = rhs - al * v_min;
      if (g == N - 2) rhs = rhs - au * v_max;
      s_ping[i] = rhs;
    }
    __syncthreads();

    // forward reduction: src (m rows) -> dst (m/2 rows), evens to the stack
    T* src = s_ping;
    T* dst = s_pong;
    int m = n, off = 0;
    for (int lev = 0; lev < n_levels; ++lev) {
      const int half = m >> 1;
      const T* lv = L + lev * kSlots;
      for (int j = tid; j < half; j += nt) {
        const T e = src[2 * j], o = src[2 * j + 1];
        const T e_up = j < half - 1 ? src[2 * j + 2] : T(0);
        s_stack[off + j] = e;
        dst[j] = o - cls(lv, kAlpha, j, half) * e - cls(lv, kGamma, j, half) * e_up;
      }
      __syncthreads();
      T* tmp = src;
      src = dst;
      dst = tmp;
      off += half;
      m = half;
    }
    if (tid == 0) src[0] = src[0] / L[kBFinal];
    __syncthreads();

    // back-substitution: src (half rows) -> dst (2 half rows); the last
    // level writes the interior rows of the value row
    for (int lev = n_levels - 1; lev >= 0; --lev) {
      const int half = m;
      off -= half;
      const T* lv = L + lev * kSlots;
      T* out = lev == 0 ? s_v + 1 : dst;
      for (int j = tid; j < half; j += nt) {
        const T x = src[j];
        const T x_lo = j > 0 ? src[j - 1] : T(0);
        const T xe = (s_stack[off + j] - cls(lv, kAe, j, half) * x_lo - cls(lv, kCe, j, half) * x) /
                     cls(lv, kBe, j, half);
        out[2 * j] = xe;
        out[2 * j + 1] = x;
      }
      __syncthreads();
      T* tmp = src;
      src = dst;
      dst = tmp;
      m = 2 * half;
    }

    // edges and knock-out projection; each thread rewrites only its rows
    for (int g = tid; g < N; g += nt) {
      T x = g == 0 ? v_min : (g == N - 1 ? v_max : s_v[g]);
      if (mon_k && om[g] != T(0)) x = rebate_pv;
      s_v[g] = x;
    }
    __syncthreads();
  }

  for (int g = tid; g < N; g += nt) v_out[base + g] = s_v[g];
}

template <typename T>
int launch(const void* trade, const void* coef, const void* lvl, const void* omask,
           const void* tau, const void* mon, const void* v_in, void* v_out, int B, int N,
           int n_levels, int n_steps, int n_rann, void* stream) {
  const int n = N - 2;
  if (B <= 0 || n < 2 || (n & (n - 1)) != 0 || (1 << n_levels) != n || n_steps < 0 ||
      n_rann < 0 || n_rann > n_steps)
    return (int)cudaErrorInvalidValue;
  int threads = n / 2 < 32 ? 32 : n / 2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem =
      ((size_t)N + n + n / 2 + n + 2 * (size_t)n_levels * kSlots) * sizeof(T);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cr_march_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cr_march_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      (const T*)trade, (const T*)coef, (const T*)lvl, (const T*)omask, (const T*)tau,
      (const T*)mon, (const T*)v_in, (T*)v_out, B, N, n_levels, n_steps, n_rann);
  return (int)cudaGetLastError();
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

const char* cr_march_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

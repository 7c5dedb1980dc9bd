// Fused Crank-Nicolson march of a barrier batch with Hillis-Steele affine
// scans, for Hopper (sm_90a).
//
// Replaces the TPU kernel finite_difference_tpu/models/pde/pallas_kernel.py
// `_kernel` (launched by `cn_barrier_solve_pallas`). Its plain PyTorch
// version is finite_difference_tpu_torch/models/pde/fused.py
// `hs_march_reference`, whose module documents the prep and the layout:
// trades on the leading axis, one trade's N nodes contiguous, solver set 0
// (theta = 1) on steps k < n_rann and set 1 (theta = 1/2) after.
//
// One launch runs the whole march: per step the explicit rhs with the
// Dirichlet edges from tau, the forward recurrence d_i = af_i d_{i-1} +
// w_i rhs_i and the backward recurrence x_i = ab_i x_{i+1} + d_i over the
// closed-form constant-diagonal Thomas vectors, then the edges and the
// knock-out projection to the rebate PV on monitor steps.
//
// Mapping. One block per trade. Thread t owns R contiguous rows [t*R,
// t*R + R), R the smallest of 1, 2, 4 that keeps the block at <= 256
// threads (R = 4 at N = 1024; N up to 4096 with up to 1024 threads). The
// value rows and, for the current theta set, the thread's w, af and ab stay
// in registers for the whole march; the set changes once, after the
// Rannacher steps. The rhs reads the two neighbours across thread
// boundaries through a row in shared memory. Each recurrence is a scan of
// affine maps y -> a*y + b: the thread composes its own R rows, a
// Kogge-Stone (Hillis-Steele) scan over the warp's lanes with shuffles
// gives each lane the composition of the lanes before it, warp 0 scans the
// warp aggregates the same way through shared memory, and each thread then
// runs its own rows forward from the value entering it. The TPU's (N, 128)
// lane layout and its circular rolls are not carried over. Rows >= N of the
// last threads are phantom rows with a = b = 0, which no real row reads
// across: af is 0 on rows 0, 1, N-1 and ab on rows 0, N-2, N-1.
//
// Bound. About 10 flops per interior node and step (rhs 5, forward 3,
// backward 2): at B=4096, N=1024, 512 steps, f32, 0.32 ms at the published
// 67 TFLOP/s, against about 0.05 ms for the bytes the march must move
// (solver vectors, mask, payoff and the result, once each), so operations
// bound it. The scans spend more than the recurrences need: each of the two
// spends 3 flops per shuffle stage per thread (5 stages) and the
// compositions, overhead of the design. Each step also takes five block
// barriers (the neighbour row and two per scan), so the march is more likely
// latency-bound than either. chip_smoke.py measured 6.8 ms per march at
// that size on one NVIDIA H100 80GB HBM3 (700 W), 21x the bound; what
// limits it is not measured.
//
// Precise math only: expf/exp, no --use_fast_math. nvcc contracts a*b+c into
// FMA by default, and the scan composes in another order than the plain
// version's doubling scan, so results differ at the rounding level.

#include <cuda_runtime.h>

namespace {

constexpr int kTradeCols = 9;  // fused.TRADE_COLS
constexpr int kCoefCols = 5;   // fused.COEF_COLS
constexpr int kTargetThreads = 256;
constexpr int kMaxRows = 4;
constexpr int kMaxThreads = 1024;
constexpr int kAgg = 96;  // per scan: 32 aggregate maps (a, b), 32 entry values
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// Value from the lane `s` before this one in scan order (up for the forward
// scan, down for the reverse one).
template <bool Reverse, typename T>
__device__ __forceinline__ T from_before(T x, int s) {
  return Reverse ? __shfl_down_sync(kFull, x, s) : __shfl_up_sync(kFull, x, s);
}

// Kogge-Stone scan of affine maps over the 32 lanes of a warp: on return
// (a, b) is the composition of the maps of this lane and of every lane
// before it in scan order. All lanes must call it.
template <bool Reverse, typename T>
__device__ __forceinline__ void warp_scan(T& a, T& b, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const T a_p = from_before<Reverse>(a, s);
    const T b_p = from_before<Reverse>(b, s);
    if (Reverse ? lane + s < 32 : lane >= s) {
      b = a * b_p + b;
      a = a * a_p;
    }
  }
}

// Block-wide solve of y_i = a_i y_{i-1} + b_i (forward; Reverse: y_i = a_i
// y_{i+1} + b_i) over the rows the threads own, y before the first = 0.
// `y` holds the b_i on entry and the solution on return. `agg` is this
// scan's own kAgg values of shared memory. Two block barriers.
template <typename T, int R, bool Reverse>
__device__ __forceinline__ void block_scan(const T (&a)[R], T (&y)[R], T* __restrict__ agg,
                                           int lane, int warp, int n_warps) {
  // the thread's rows in scan order, composed into one map
  T A = T(1), Bm = T(0);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = Reverse ? R - 1 - q : q;
    Bm = a[r] * Bm + y[r];
    A = a[r] * A;
  }
  warp_scan<Reverse>(A, Bm, lane);
  if (lane == (Reverse ? 0 : 31)) {
    agg[warp] = A;
    agg[32 + warp] = Bm;
  }
  __syncthreads();
  if (warp == 0) {
    // lanes past the last warp hold the identity map, which is neutral
    T a_w = T(1), b_w = T(0);
    if (lane < n_warps) {
      a_w = agg[lane];
      b_w = agg[32 + lane];
    }
    warp_scan<Reverse>(a_w, b_w, lane);
    // the value entering warp `lane`: that leaving the warp before it
    T enter = from_before<Reverse>(b_w, 1);
    if (lane == (Reverse ? 31 : 0)) enter = T(0);
    agg[64 + lane] = enter;
  }
  __syncthreads();
  // the value entering this thread: the maps of the lanes before it applied
  // to the value entering the warp
  T a_e = from_before<Reverse>(A, 1);
  T b_e = from_before<Reverse>(Bm, 1);
  if (lane == (Reverse ? 31 : 0)) {
    a_e = T(1);
    b_e = T(0);
  }
  T yv = a_e * agg[64 + warp] + b_e;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = Reverse ? R - 1 - q : q;
    yv = a[r] * yv + y[r];
    y[r] = yv;
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads)
hs_march_kernel(
    const T* __restrict__ trade,   // (B, 9)
    const T* __restrict__ coef,    // (2, B, 5) bl, bc, bu, al, au per set
    const T* __restrict__ fields,  // (2, 3, B, N) w, af, ab per set
    const T* __restrict__ omask,   // (B, N)
    const T* __restrict__ tau,     // (B, n_steps)
    const T* __restrict__ mon,     // (B, n_steps)
    const T* __restrict__ v_in,    // (B, N)
    T* __restrict__ v_out,         // (B, N)
    int B, int N, int n_steps, int n_rann) {
  extern __shared__ unsigned char smem_raw[];
  T* __restrict__ s_v = reinterpret_cast<T*>(smem_raw);  // blockDim.x * R
  T* __restrict__ agg_f = s_v + blockDim.x * R;
  T* __restrict__ agg_b = agg_f + kAgg;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g0 = tid * R;

  const T* tr = trade + (size_t)b * kTradeCols;
  const T strike = tr[0], r = tr[2], growth_rate = tr[3], rebate = tr[4];
  const T rebate_rate = tr[6], s_min = tr[7], s_max = tr[8];
  const bool is_call = tr[1] != T(0), at_hit = tr[5] != T(0);
  const size_t base = (size_t)b * N;
  const size_t plane = (size_t)B * N;
  const T* __restrict__ tau_b = tau + (size_t)b * n_steps;
  const T* __restrict__ mon_b = mon + (size_t)b * n_steps;

  T v[R];
  bool om[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int g = g0 + q;
    v[q] = g < N ? v_in[base + g] : T(0);
    om[q] = g < N && omask[base + g] != T(0);
  }

  for (int set = 0; set < 2; ++set) {
    const int k_lo = set == 0 ? 0 : n_rann;
    const int k_hi = set == 0 ? n_rann : n_steps;
    if (k_lo >= k_hi) continue;
    const T* cf = coef + ((size_t)set * B + b) * kCoefCols;
    const T bl = cf[0], bc = cf[1], bu = cf[2], al = cf[3], au = cf[4];
    const T* __restrict__ fw = fields + (size_t)set * 3 * plane + base;
    T w[R], af[R], ab[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int g = g0 + q;
      w[q] = g < N ? fw[g] : T(0);
      af[q] = g < N ? fw[plane + g] : T(0);
      ab[q] = g < N ? fw[2 * plane + g] : T(0);
    }

    for (int k = k_lo; k < k_hi; ++k) {
      const T t = tau_b[k];
      const T growth = exp_(growth_rate * t);
      const T disc = exp_(-r * t);
      const T v_min = is_call ? T(0) : strike * disc - s_min * growth;
      const T v_max = is_call ? s_max * growth - strike * disc : T(0);
      const bool mon_k = mon_b[k] != T(0);
      const T rebate_pv = at_hit ? rebate : rebate * exp_(-rebate_rate * t);

      // the neighbour row; the previous step's readers are past both scans'
      // barriers, so it may be overwritten
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (g0 + q < N) s_v[g0 + q] = v[q];
      __syncthreads();

      T y[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int g = g0 + q;
        T rhs = T(0);
        if (g >= 1 && g <= N - 2) {
          const T v_dn = q > 0 ? v[q - 1] : s_v[g - 1];
          const T v_up = q < R - 1 ? v[q + 1] : s_v[g + 1];
          rhs = bl * v_dn + bc * v[q] + bu * v_up;
          if (g == 1) rhs = rhs - al * v_min;
          if (g == N - 2) rhs = rhs - au * v_max;
        }
        y[q] = w[q] * rhs;
      }
      block_scan<T, R, false>(af, y, agg_f, lane, warp, n_warps);
      block_scan<T, R, true>(ab, y, agg_b, lane, warp, n_warps);

#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int g = g0 + q;
        T x = g == 0 ? v_min : (g == N - 1 ? v_max : y[q]);
        if (mon_k && om[q]) x = rebate_pv;
        v[q] = x;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < R; ++q)
    if (g0 + q < N) v_out[base + g0 + q] = v[q];
}

template <typename T, int R>
void launch_rows(int threads, size_t smem, cudaStream_t stream, const void* trade,
                 const void* coef, const void* fields, const void* omask, const void* tau,
                 const void* mon, const void* v_in, void* v_out, int B, int N, int n_steps,
                 int n_rann) {
  hs_march_kernel<T, R><<<B, threads, smem, stream>>>(
      (const T*)trade, (const T*)coef, (const T*)fields, (const T*)omask, (const T*)tau,
      (const T*)mon, (const T*)v_in, (T*)v_out, B, N, n_steps, n_rann);
}

template <typename T>
int launch(const void* trade, const void* coef, const void* fields, const void* omask,
           const void* tau, const void* mon, const void* v_in, void* v_out, int B, int N,
           int n_steps, int n_rann, void* stream) {
  if (B <= 0 || N < 3 || n_steps < 0 || n_rann < 0 || n_rann > n_steps)
    return (int)cudaErrorInvalidValue;
  int rows = 1;
  while (rows < kMaxRows && (N + rows - 1) / rows > kTargetThreads) rows *= 2;
  const int threads = ((N + rows - 1) / rows + 31) / 32 * 32;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)threads * rows + 2 * kAgg) * sizeof(T);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 1:
      launch_rows<T, 1>(threads, smem, s, trade, coef, fields, omask, tau, mon, v_in, v_out, B,
                        N, n_steps, n_rann);
      break;
    case 2:
      launch_rows<T, 2>(threads, smem, s, trade, coef, fields, omask, tau, mon, v_in, v_out, B,
                        N, n_steps, n_rann);
      break;
    default:
      launch_rows<T, 4>(threads, smem, s, trade, coef, fields, omask, tau, mon, v_in, v_out, B,
                        N, n_steps, n_rann);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define HS_MARCH_ARGS                                                          \
  const void *trade, const void *coef, const void *fields, const void *omask, \
      const void *tau, const void *mon, const void *v_in, void *v_out, int B, \
      int N, int n_steps, int n_rann, void *stream
#define HS_MARCH_CALL \
  trade, coef, fields, omask, tau, mon, v_in, v_out, B, N, n_steps, n_rann, stream

extern "C" {

int hs_march_f32(HS_MARCH_ARGS) { return launch<float>(HS_MARCH_CALL); }

int hs_march_f64(HS_MARCH_ARGS) { return launch<double>(HS_MARCH_CALL); }

const char* hs_march_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

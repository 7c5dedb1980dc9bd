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
// knock-out projection to the rebate PV on monitor steps. Each recurrence
// is a scan of affine maps y -> a*y + b: a thread composes the maps of its
// own R rows, a Kogge-Stone (Hillis-Steele) scan over the warp's lanes with
// shuffles gives each lane the composition of the lanes before it, and the
// thread runs its rows forward from the value entering it. The TPU's
// (N, 128) lane layout and its circular rolls are not carried over. Rows
// >= N of the last lanes are phantom rows with a = b = 0, which no real row
// reads across: af is 0 on rows 0, 1, N-1 and ab on rows 0, N-2, N-1.
//
// The launch rule (kernels.hs_block mirrors it) picks one of two designs
// by N alone:
//
// - N <= 1024, one warp per trade (hs_warp_kernel), 4 trades per block of
//   128 threads. Lane l owns rows [l*R, l*R + R), R = ceil(N/32) rounded
//   up to a power of two (1 ... 32). The values stay in registers; the rhs
//   is formed in place, carrying each row's old value to the next, with
//   two shuffles for the neighbours across the lane edges. The current
//   theta set's w, af and ab sit in shared memory, row l*R + q at
//   l*(R|1) + q (an odd stride for R >= 2: a warp's loads are free of bank
//   conflicts at f32), loaded coalesced once per set; the knock-out mask is
//   one bitmask register. No block barrier runs in the march, and nothing
//   but the shuffles synchronises a step. Every 32 steps each lane computes
//   one step's edges and rebate PV (three exponentials), which the steps
//   then take by shuffle. 12.4 KB of shared memory per trade at f32 and
//   N = 1024: 16 trades per SM (kernels.hs_resident_trades asks the
//   occupancy API), so B = 4096 runs in two waves of 2112.
// - 1024 < N <= 4096, one block per trade (hs_march_kernel, the first
//   port's design), thread t owning R contiguous rows, R the smallest of
//   1, 2, 4 that keeps the block at <= 256 threads, up to 1024 threads.
//   The value rows and the thread's w, af and ab stay in registers; the
//   rhs reads the neighbours through a row in shared memory, and warp 0
//   scans the warp aggregates through shared memory: five block barriers
//   per step.
//
// Bound. About 10 flops per interior node and step (rhs 5, forward 3,
// backward 2): at B=4096, N=1024, 512 steps, f32, 0.32 ms at the published
// 67 TFLOP/s, against about 0.05 ms for the bytes the march must move
// (solver vectors, mask, payoff and the result, once each), so operations
// bound it. The scans spend more than the recurrences need: per row the
// composition and the application (5 flops against 3 and 2), and per lane
// 5 shuffle stages of 3 flops per scan, overhead of the design. The block
// design took 6.8 ms per march at that size on one NVIDIA H100 80GB HBM3
// (700 W), 21x the bound, its barriers holding every step. The warp design
// issues about 600 warp instructions per trade and step, so instruction
// issue, not latency, should set its pace with 4 warps per scheduler;
// PERF.md has its time.
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
constexpr int kWarpMaxNodes = 1024;  // kernels.HS_WARP_MAX_NODES
constexpr int kTradesPerBlock = 4;   // kernels.HS_TRADES_PER_BLOCK

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

// ---- one warp per trade (N <= 1024) ----------------------------------------

// shared-memory stride of a lane's R rows: R + 1 for R >= 2 (odd), 1 for R = 1
template <int R>
constexpr int kStride = R | 1;

// blocks per SM the launch bounds ask registers for: what shared memory
// allows at N = 1024 (4 trades of 12.4 KB in f32, 24.8 KB in f64)
template <typename T>
constexpr int kWarpMinBlocks = sizeof(T) == 4 ? 4 : 2;

// Solve y_i = a_i y_{i-1} + v_i (forward; Reverse: y_i = a_i y_{i+1} + v_i)
// over the warp's rows, y before the first = 0; `a` is this lane's R
// coefficients in shared memory, `v` its rows, the solution on return.
template <typename T, int R, bool Reverse>
__device__ __forceinline__ void warp_solve(const T* a, T (&v)[R], int lane) {
  T A = T(1), Bm = T(0);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int q = Reverse ? R - 1 - i : i;
    Bm = a[q] * Bm + v[q];
    A = a[q] * A;
  }
  warp_scan<Reverse>(A, Bm, lane);
  // the value entering this lane: that leaving the lane before it
  T y = from_before<Reverse>(Bm, 1);
  if (lane == (Reverse ? 31 : 0)) y = T(0);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int q = Reverse ? R - 1 - i : i;
    y = a[q] * y + v[q];
    v[q] = y;
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(32 * kTradesPerBlock, kWarpMinBlocks<T>)
hs_warp_kernel(
    const T* __restrict__ trade,   // (B, 9)
    const T* __restrict__ coef,    // (2, B, 5) bl, bc, bu, al, au per set
    const T* __restrict__ fields,  // (2, 3, B, N) w, af, ab per set
    const T* __restrict__ omask,   // (B, N)
    const T* __restrict__ tau,     // (B, n_steps)
    const T* __restrict__ mon,     // (B, n_steps)
    const T* __restrict__ v_in,    // (B, N)
    T* __restrict__ v_out,         // (B, N)
    int B, int N, int n_steps, int n_rann) {
  constexpr int S = kStride<R>;
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kTradesPerBlock + warp;
  if (b >= B) return;  // ragged last block: whole warps drop out
  // this trade's w, af, ab (32 * S values each) and this lane's rows in them
  // (not restrict: the lanes write the rows that they read after __syncwarp)
  T* s_set = reinterpret_cast<T*>(smem_raw) + (size_t)warp * 3 * 32 * S;
  const T* my_w = s_set + lane * S;
  const T* my_af = my_w + 32 * S;
  const T* my_ab = my_af + 32 * S;
  const int g0 = lane * R;

  const T* tr = trade + (size_t)b * kTradeCols;
  const T strike = tr[0], r = tr[2], growth_rate = tr[3], rebate = tr[4];
  const T rebate_rate = tr[6], s_min = tr[7], s_max = tr[8];
  const bool is_call = tr[1] != T(0), at_hit = tr[5] != T(0);
  const size_t base = (size_t)b * N;
  const size_t plane = (size_t)B * N;
  const T* __restrict__ tau_b = tau + (size_t)b * n_steps;
  const T* __restrict__ mon_b = mon + (size_t)b * n_steps;

  T v[R];
  unsigned om = 0;  // bit q: row g0 + q is knocked out on monitor steps
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int g = g0 + q;
    v[q] = g < N ? v_in[base + g] : T(0);
    if (g < N && omask[base + g] != T(0)) om |= 1u << q;
  }

  for (int set = 0; set < 2; ++set) {
    const int k_lo = set == 0 ? 0 : n_rann;
    const int k_hi = set == 0 ? n_rann : n_steps;
    if (k_lo >= k_hi) continue;
    const T* cf = coef + ((size_t)set * B + b) * kCoefCols;
    const T bl = cf[0], bc = cf[1], bu = cf[2], al = cf[3], au = cf[4];
    const T* __restrict__ fw = fields + (size_t)set * 3 * plane + base;
    __syncwarp();  // the previous set's readers are done
    for (int c = 0; c < 3; ++c)
      for (int i = lane; i < 32 * R; i += 32)
        s_set[c * 32 * S + (i / R) * S + i % R] = i < N ? fw[c * plane + i] : T(0);
    __syncwarp();

    for (int k0 = k_lo; k0 < k_hi; k0 += 32) {
      // lane j computes step k0 + j's edges and rebate PV
      T t_min = T(0), t_max = T(0), t_pv = T(0);
      bool t_mon = false;
      if (k0 + lane < k_hi) {
        const T t = tau_b[k0 + lane];
        const T growth = exp_(growth_rate * t);
        const T disc = exp_(-r * t);
        t_min = is_call ? T(0) : strike * disc - s_min * growth;
        t_max = is_call ? s_max * growth - strike * disc : T(0);
        t_mon = mon_b[k0 + lane] != T(0);
        t_pv = at_hit ? rebate : rebate * exp_(-rebate_rate * t);
      }
      const unsigned mon_bits = __ballot_sync(kFull, t_mon);
      const int n_k = min(32, k_hi - k0);
      for (int j = 0; j < n_k; ++j) {
        const T v_min = __shfl_sync(kFull, t_min, j);
        const T v_max = __shfl_sync(kFull, t_max, j);
        const T rebate_pv = __shfl_sync(kFull, t_pv, j);
        const bool mon_k = (mon_bits >> j) & 1u;

        // the explicit rhs times w, in place: `prev` carries the old value
        // of the row below
        T prev = __shfl_up_sync(kFull, v[R - 1], 1);
        const T above = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int g = g0 + q;
          const T cur = v[q];
          const T up = q < R - 1 ? v[q + 1] : above;
          T rhs = T(0);
          if (g >= 1 && g <= N - 2) {
            rhs = bl * prev + bc * cur + bu * up;
            if (g == 1) rhs = rhs - al * v_min;
            if (g == N - 2) rhs = rhs - au * v_max;
          }
          v[q] = my_w[q] * rhs;
          prev = cur;
        }
        warp_solve<T, R, false>(my_af, v, lane);
        warp_solve<T, R, true>(my_ab, v, lane);

#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int g = g0 + q;
          T x = g == 0 ? v_min : (g == N - 1 ? v_max : v[q]);
          if (mon_k && ((om >> q) & 1u)) x = rebate_pv;
          v[q] = x;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < R; ++q)
    if (g0 + q < N) v_out[base + g0 + q] = v[q];
}

// rows per lane of the warp design: the least power of two R with 32 R >= N
inline int warp_rows(int N) {
  int rows = 1;
  while (32 * rows < N) rows *= 2;
  return rows;
}

template <typename T, int R>
size_t warp_smem() {
  return (size_t)kTradesPerBlock * 3 * 32 * kStride<R> * sizeof(T);
}

template <typename T, int R>
cudaError_t warp_opt_in() {
  const size_t smem = warp_smem<T, R>();
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(hs_warp_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int R>
int launch_warp(cudaStream_t stream, const void* trade, const void* coef, const void* fields,
                const void* omask, const void* tau, const void* mon, const void* v_in,
                void* v_out, int B, int N, int n_steps, int n_rann) {
  const cudaError_t e = warp_opt_in<T, R>();
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + kTradesPerBlock - 1) / kTradesPerBlock;
  hs_warp_kernel<T, R><<<grid, 32 * kTradesPerBlock, warp_smem<T, R>(), stream>>>(
      (const T*)trade, (const T*)coef, (const T*)fields, (const T*)omask, (const T*)tau,
      (const T*)mon, (const T*)v_in, (T*)v_out, B, N, n_steps, n_rann);
  return (int)cudaGetLastError();
}

// trades per SM of the warp design at R rows per lane (occupancy API)
template <typename T, int R>
int warp_occupancy(int* trades_per_sm) {
  cudaError_t e = warp_opt_in<T, R>();
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, hs_warp_kernel<T, R>,
                                                    32 * kTradesPerBlock, warp_smem<T, R>());
  if (e != cudaSuccess) return (int)e;
  *trades_per_sm = blocks * kTradesPerBlock;
  return 0;
}

// ---- one block per trade (1024 < N <= 4096) ------------------------------

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
  const cudaStream_t s = (cudaStream_t)stream;
  if (N <= kWarpMaxNodes) {
#define HS_WARP_LAUNCH(R)                                                                   \
  case R:                                                                                    \
    return launch_warp<T, R>(s, trade, coef, fields, omask, tau, mon, v_in, v_out, B, N, \
                             n_steps, n_rann);
    switch (warp_rows(N)) {
      HS_WARP_LAUNCH(1)
      HS_WARP_LAUNCH(2)
      HS_WARP_LAUNCH(4)
      HS_WARP_LAUNCH(8)
      HS_WARP_LAUNCH(16)
      HS_WARP_LAUNCH(32)
    }
#undef HS_WARP_LAUNCH
    return (int)cudaErrorInvalidValue;
  }
  int rows = 1;
  while (rows < kMaxRows && (N + rows - 1) / rows > kTargetThreads) rows *= 2;
  const int threads = ((N + rows - 1) / rows + 31) / 32 * 32;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)threads * rows + 2 * kAgg) * sizeof(T);
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

// trades resident per SM of the warp design at N <= 1024 nodes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times trades per block)
template <typename T>
int occupancy(int N, int* trades_per_sm) {
  if (N < 3 || N > kWarpMaxNodes) return (int)cudaErrorInvalidValue;
  switch (warp_rows(N)) {
    case 1: return warp_occupancy<T, 1>(trades_per_sm);
    case 2: return warp_occupancy<T, 2>(trades_per_sm);
    case 4: return warp_occupancy<T, 4>(trades_per_sm);
    case 8: return warp_occupancy<T, 8>(trades_per_sm);
    case 16: return warp_occupancy<T, 16>(trades_per_sm);
    case 32: return warp_occupancy<T, 32>(trades_per_sm);
  }
  return (int)cudaErrorInvalidValue;
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

// trades resident per SM for a launch at N nodes (see occupancy above)
int hs_march_occupancy(int f64, int N, int* trades_per_sm) {
  return f64 ? occupancy<double>(N, trades_per_sm) : occupancy<float>(N, trades_per_sm);
}

const char* hs_march_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// SPIKE Crank-Nicolson march of a barrier or American batch, one
// (theta, dt) segment per launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel finite_difference_tpu/models/pde/pallas_kernel.py
// `_kernel_spike`, both branches (template parameter American), and, at
// double, `_kernel_spike_df64`: the TPU emulates float64 with f32 pairs,
// the H100 has it natively. Its plain PyTorch version is
// finite_difference_tpu_torch/models/pde/spike.py `spike_march_reference`,
// which also documents the layout: a trade's interior rows are stored as
// r = ii*P + j (chunk j, in-chunk row ii), trades on the leading axis.
//
// American branch (Ikonen-Toivanen). Each trade has a second n_pad row of
// shared memory for lambda, beside the value row; lane j reads and writes
// only the lambda of its own chunk, so it needs no extra synchronisation.
// Per step: the rhs is written in row-sum form, bsum*v + bl*(v_prev - v) +
// bu*(v_next - v) with bsum = 1 - (1-theta)*dt*r from the host (equal to
// bc*v + bl*v_prev + bu*v_next in exact arithmetic; at the American grid's
// dt/dx^2 rounding bc to float keeps only ~90% of the discount term, see
// spike_march_reference), it gains dt*lambda, and after the spike correction
// v = max(payoff, x - dt*lambda), lambda = max(0, lambda + (payoff - x)/dt)
// with a true division (the plain version divides too). The payoff is
// segment-constant and read from global memory, like the solver vectors;
// dt is the sixth coefficient column. On a pad row payoff = lambda = x = 0,
// so the update keeps it 0. The put's lower edge is K e^{-r tau}. The
// second row doubles the shared memory a trade needs (8 KB in f32, 16 KB in
// f64 at N=1024), so at B=4096 in f32 not every trade is resident at once.
// The European instantiation compiles as before: every American addition is
// behind `if constexpr`.
//
// Mapping. One warp per trade, lane j < P walks chunk j. The trade's value
// row (n_pad values) lives in shared memory for the whole segment; the
// forward-sweep scratch `dp` aliases it in place, because lane j reads only
// its own chunk once the two cross-chunk neighbours of a step are captured,
// and each row is consumed before its slot is overwritten. That halves the
// shared memory a trade needs (4 KB at N=1024 in f32), so all 4096 trades of
// the main path are resident at once (31 per SM). The five solver vectors
// and the interface inverse are constant over the segment and are read from
// global memory (L2), one coalesced 32-wide row per band. The 2P x 2P
// interface matvec runs across the lanes, with the chunk tips broadcast by
// warp shuffles. Steps run inside the kernel; nothing is allocated here.
//
// Bound. Per interior node and step about 14 flops (rhs 5, forward 3,
// backward 2, correction 4), plus a banded solve of the 2P-unknown interface
// system (each unknown couples only to b_{j-1} and t_{j+1}), about 9 flops
// per unknown: at B=4096, N=1024, 512 steps and P=32 about 3.1e10 flops,
// 0.47 ms at the published 67 TFLOP/s f32, against about 0.07 ms for the
// bytes the march must move. So the bound is operations. The dense 2P x 2P
// matvec used here spends 2*(2P)^2 flops per trade and step instead (1.7e10
// more at that size): overhead of this design, kept because it is one
// shuffle-broadcast loop across the lanes. What limits the kernel is not
// measured yet; a likely limiter is latency, since each step is two
// dependent chains of m = N/P rows per lane. The design shortens them with
// P=32 (chains of 32, not 128 as with the TPU's P=8) and keeps every trade
// resident so that other warps can cover a chain's stalls.
//
// Precise math only: expf/exp, no --use_fast_math. nvcc contracts a*b+c into
// FMA by default, which is why f32 results differ from the plain version at
// the rounding level.

#include <cuda_runtime.h>

namespace {

constexpr int kTradeCols = 11;  // spike.TRADE_COLS
constexpr int kCoefCols = 7;    // spike.COEF_COLS
constexpr int kTradesPerBlock = 4;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T max_(T a, T b) { return a > b ? a : b; }

template <typename T, bool American>
__global__ void __launch_bounds__(32 * kTradesPerBlock)
spike_march_kernel(
    const T* __restrict__ trade,   // (B, 11)
    const T* __restrict__ coef,    // (B, 7) bl, bc, bu, al, au, dt, bsum
    const T* __restrict__ fields,  // (5, B, n_pad): spike.FIELD_ROWS
    const T* __restrict__ rinv,    // (B, 2P, 2P) [trade, column, row]
    const T* __restrict__ omask,   // (B, n_pad)
    const T* __restrict__ tau,     // (B, n_sched)
    const T* __restrict__ mon,     // (B, n_sched)
    const T* __restrict__ v_in,    // (B, n_pad)
    const T* __restrict__ edge_in, // (B, 2)
    T* __restrict__ v_out,         // (B, n_pad)
    T* __restrict__ edge_out,      // (B, 2)
    const T* __restrict__ payoff,  // (B, n_pad), American only
    const T* __restrict__ lam_in,  // (B, n_pad), American only
    T* __restrict__ lam_out,       // (B, n_pad), American only
    int B, int n_pad, int m, int P, int il, int k0, int ns, int n_sched) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // ragged last block: whole warps drop out
  constexpr int kRows = American ? 2 : 1;
  T* __restrict__ row = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kRows * n_pad;
  T* __restrict__ lam = row + n_pad;  // American only
  const bool act = lane < P;
  const int j = lane;

  const T* tr = trade + (size_t)b * kTradeCols;
  const T strike = tr[0], r = tr[2], growth_rate = tr[3];
  const T rebate = tr[4], rebate_rate = tr[6], s_min = tr[7], s_max = tr[8];
  const bool is_call = tr[1] != T(0), at_hit = tr[5] != T(0);
  const bool omask_lo = tr[9] != T(0), omask_hi = tr[10] != T(0);
  const T* cf = coef + (size_t)b * kCoefCols;
  const T bl = cf[0], bc = cf[1], bu = cf[2], al = cf[3], au = cf[4];
  const T dt = cf[5], bsum = cf[6];  // read by the American branch only

  const size_t plane = (size_t)B * n_pad;
  const size_t base = (size_t)b * n_pad;
  const T* __restrict__ w = fields + base;
  const T* __restrict__ af = fields + plane + base;
  const T* __restrict__ ab = fields + 2 * plane + base;
  const T* __restrict__ vsp = fields + 3 * plane + base;
  const T* __restrict__ wsp = fields + 4 * plane + base;
  const T* __restrict__ om = omask + base;
  const T* __restrict__ ri = rinv + (size_t)b * (2 * P) * (2 * P);
  const T* __restrict__ tau_b = tau + (size_t)b * n_sched + k0;
  const T* __restrict__ mon_b = mon + (size_t)b * n_sched + k0;

  const T* __restrict__ pay = American ? payoff + base : nullptr;
  if (act)
    for (int ii = 0; ii < m; ++ii) row[ii * P + j] = v_in[base + ii * P + j];
  if constexpr (American) {
    if (act)
      for (int ii = 0; ii < m; ++ii) lam[ii * P + j] = lam_in[base + ii * P + j];
  }
  T v_lo = edge_in[2 * b], v_hi = edge_in[2 * b + 1];
  const int last = (m - 1) * P;

  for (int k = 0; k < ns; ++k) {
    const T t = tau_b[k];
    const T growth = exp_(growth_rate * t);
    const T disc = exp_(-r * t);
    T v_min_put = strike * disc;
    if constexpr (!American) v_min_put = v_min_put - s_min * growth;
    const T v_min_n = is_call ? T(0) : v_min_put;
    const T v_max_n = is_call ? s_max * growth - strike * disc : T(0);

    // the two cross-chunk neighbours of this step, captured before any
    // lane overwrites its rows with the forward-sweep values
    __syncwarp();
    T v_prev = T(0), v_cur = T(0), up_fix = T(0);
    if (act) {
      v_prev = j == 0 ? v_lo : row[last + j - 1];
      v_cur = row[j];
      up_fix = row[j + 1 < P ? j + 1 : 0];
    }
    __syncwarp();

    // band-streamed rhs fused into the forward Thomas chain; row ii's slot
    // takes d'_ii once v_ii has been read
    T d = T(0);
    if (act) {
#pragma unroll 4
      for (int ii = 0; ii < m; ++ii) {
        const int ri_ = ii * P + j;
        const T v_next = ii < m - 1 ? row[ri_ + P] : up_fix;
        T rhs;
        if constexpr (American) {
          // row-sum form (spike.spike_march_reference): the global-last
          // row's upper neighbour is the edge itself
          const T vn = (j == P - 1 && ii == il) ? v_hi : v_next;
          rhs = bsum * v_cur + bl * (v_prev - v_cur) + bu * (vn - v_cur);
          rhs = rhs + dt * lam[ri_];
          if (ii == 0 && j == 0) rhs = rhs - al * v_min_n;
          if (j == P - 1) {
            if (ii == il) rhs = rhs - au * v_max_n;
            else if (ii > il) rhs = T(0);  // pad rows
          }
        } else {
          rhs = bc * v_cur + bl * v_prev + bu * v_next;
          if (ii == 0 && j == 0) rhs = rhs - al * v_min_n;
          if (j == P - 1) {
            if (ii == il) rhs = rhs + (bu * v_hi - au * v_max_n);
            else if (ii > il) rhs = T(0);  // pad rows
          }
        }
        d = ii == 0 ? w[ri_] * rhs : w[ri_] * rhs + af[ri_] * d;
        row[ri_] = d;
        v_prev = v_cur;
        v_cur = v_next;
      }
    }
    // backward chain: y_ii = d'_ii + ab_ii * y_{ii+1}
    const T y_bot = d;
    T x = d;
    if (act) {
#pragma unroll 4
      for (int ii = m - 2; ii >= 0; --ii) {
        const int ri_ = ii * P + j;
        x = row[ri_] + ab[ri_] * x;
        row[ri_] = x;
      }
    }
    const T y_top = x;

    // 2P interface solve with the precomputed inverse: lane j forms
    // u[j] = t_j and u[P+j] = b_j
    T ut = T(0), ub = T(0);
    for (int c = 0; c < P; ++c) {
      const T yt = __shfl_sync(kFull, y_top, c);
      const T yb = __shfl_sync(kFull, y_bot, c);
      if (act) {
        const T* ct = ri + (size_t)c * (2 * P);
        const T* cb = ri + (size_t)(P + c) * (2 * P);
        ut = ut + ct[j] * yt;
        ut = ut + cb[j] * yb;
        ub = ub + ct[P + j] * yt;
        ub = ub + cb[P + j] * yb;
      }
    }
    const T b_left = __shfl_sync(kFull, ub, (lane + 31) & 31);
    const T t_right = __shfl_sync(kFull, ut, (lane + 1) & 31);
    const T bprev = j == 0 ? T(0) : b_left;       // b_{j-1}
    const T tnext = j == P - 1 ? T(0) : t_right;  // t_{j+1}

    // spike correction + knock-out projection with rebate PV
    const bool mon_k = mon_b[k] != T(0);
    const T rebate_pv = at_hit ? rebate : rebate * exp_(-rebate_rate * t);
    if (act) {
#pragma unroll 4
      for (int ii = 0; ii < m; ++ii) {
        const int ri_ = ii * P + j;
        T xr = row[ri_] - bprev * vsp[ri_] - tnext * wsp[ri_];
        if constexpr (American) {
          const T lam_old = lam[ri_], p = pay[ri_];
          lam[ri_] = max_(lam_old + (p - xr) / dt, T(0));
          xr = max_(p, xr - dt * lam_old);
        }
        row[ri_] = (mon_k && om[ri_] != T(0)) ? rebate_pv : xr;
      }
    }
    v_lo = (mon_k && omask_lo) ? rebate_pv : v_min_n;
    v_hi = (mon_k && omask_hi) ? rebate_pv : v_max_n;
  }

  if (act)
    for (int ii = 0; ii < m; ++ii) v_out[base + ii * P + j] = row[ii * P + j];
  if constexpr (American) {
    if (act)
      for (int ii = 0; ii < m; ++ii) lam_out[base + ii * P + j] = lam[ii * P + j];
  }
  if (lane == 0) {
    edge_out[2 * b] = v_lo;
    edge_out[2 * b + 1] = v_hi;
  }
}

template <typename T, bool American>
int launch(const void* trade, const void* coef, const void* fields,
           const void* rinv, const void* omask, const void* tau,
           const void* mon, const void* v_in, const void* edge_in,
           void* v_out, void* edge_out, const void* payoff,
           const void* lam_in, void* lam_out, int B, int n_pad, int m, int P,
           int il, int k0, int ns, int n_sched, void* stream) {
  if (B <= 0 || P < 1 || P > 32 || m < 1 || n_pad != m * P || ns < 1 ||
      k0 < 0 || k0 + ns > n_sched || il < 0 || il >= m)
    return (int)cudaErrorInvalidValue;
  if (American && (payoff == nullptr || lam_in == nullptr || lam_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t per_trade = (size_t)n_pad * sizeof(T) * (American ? 2 : 1);
  int tpb = kTradesPerBlock;
  while (tpb > 1 && tpb * per_trade > kMaxSmem) tpb /= 2;
  const size_t smem = tpb * per_trade;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spike_march_kernel<T, American>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + tpb - 1) / tpb);
  spike_march_kernel<T, American><<<grid, 32 * tpb, smem, (cudaStream_t)stream>>>(
      (const T*)trade, (const T*)coef, (const T*)fields, (const T*)rinv,
      (const T*)omask, (const T*)tau, (const T*)mon, (const T*)v_in,
      (const T*)edge_in, (T*)v_out, (T*)edge_out, (const T*)payoff,
      (const T*)lam_in, (T*)lam_out, B, n_pad, m, P, il, k0, ns, n_sched);
  return (int)cudaGetLastError();
}

}  // namespace

#define SPIKE_MARCH_ARGS                                                     \
  const void *trade, const void *coef, const void *fields, const void *rinv, \
      const void *omask, const void *tau, const void *mon, const void *v_in, \
      const void *edge_in, void *v_out, void *edge_out, int B, int n_pad,    \
      int m, int P, int il, int k0, int ns, int n_sched, void *stream
#define SPIKE_MARCH_SHAPE B, n_pad, m, P, il, k0, ns, n_sched, stream
#define SPIKE_MARCH_IO \
  trade, coef, fields, rinv, omask, tau, mon, v_in, edge_in, v_out, edge_out

extern "C" {

int spike_march_f32(SPIKE_MARCH_ARGS) {
  return launch<float, false>(SPIKE_MARCH_IO, nullptr, nullptr, nullptr,
                              SPIKE_MARCH_SHAPE);
}

int spike_march_f64(SPIKE_MARCH_ARGS) {
  return launch<double, false>(SPIKE_MARCH_IO, nullptr, nullptr, nullptr,
                               SPIKE_MARCH_SHAPE);
}

// the American march: the European arguments followed by the payoff, lambda
// in and lambda out, each (B, n_pad)
int spike_march_american_f32(SPIKE_MARCH_ARGS, const void* payoff,
                             const void* lam_in, void* lam_out) {
  return launch<float, true>(SPIKE_MARCH_IO, payoff, lam_in, lam_out,
                             SPIKE_MARCH_SHAPE);
}

int spike_march_american_f64(SPIKE_MARCH_ARGS, const void* payoff,
                             const void* lam_in, void* lam_out) {
  return launch<double, true>(SPIKE_MARCH_IO, payoff, lam_in, lam_out,
                              SPIKE_MARCH_SHAPE);
}

const char* spike_march_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// SPIKE Crank-Nicolson march of a barrier batch, one (theta, dt) segment per
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel finite_difference_tpu/models/pde/pallas_kernel.py
// `_kernel_spike` (European branch). Its plain PyTorch version is
// finite_difference_tpu_torch/models/pde/spike.py `spike_march_reference`,
// which also documents the layout: a trade's interior rows are stored as
// r = ii*P + j (chunk j, in-chunk row ii), trades on the leading axis.
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
constexpr int kCoefCols = 5;    // spike.COEF_COLS
constexpr int kTradesPerBlock = 4;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(32 * kTradesPerBlock)
spike_march_kernel(
    const T* __restrict__ trade,   // (B, 11)
    const T* __restrict__ coef,    // (B, 5) bl, bc, bu, al, au
    const T* __restrict__ fields,  // (5, B, n_pad): spike.FIELD_ROWS
    const T* __restrict__ rinv,    // (B, 2P, 2P) [trade, column, row]
    const T* __restrict__ omask,   // (B, n_pad)
    const T* __restrict__ tau,     // (B, n_sched)
    const T* __restrict__ mon,     // (B, n_sched)
    const T* __restrict__ v_in,    // (B, n_pad)
    const T* __restrict__ edge_in, // (B, 2)
    T* __restrict__ v_out,         // (B, n_pad)
    T* __restrict__ edge_out,      // (B, 2)
    int B, int n_pad, int m, int P, int il, int k0, int ns, int n_sched) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // ragged last block: whole warps drop out
  T* __restrict__ row = reinterpret_cast<T*>(smem_raw) + (size_t)warp * n_pad;
  const bool act = lane < P;
  const int j = lane;

  const T* tr = trade + (size_t)b * kTradeCols;
  const T strike = tr[0], r = tr[2], growth_rate = tr[3];
  const T rebate = tr[4], rebate_rate = tr[6], s_min = tr[7], s_max = tr[8];
  const bool is_call = tr[1] != T(0), at_hit = tr[5] != T(0);
  const bool omask_lo = tr[9] != T(0), omask_hi = tr[10] != T(0);
  const T* cf = coef + (size_t)b * kCoefCols;
  const T bl = cf[0], bc = cf[1], bu = cf[2], al = cf[3], au = cf[4];

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

  if (act)
    for (int ii = 0; ii < m; ++ii) row[ii * P + j] = v_in[base + ii * P + j];
  T v_lo = edge_in[2 * b], v_hi = edge_in[2 * b + 1];
  const int last = (m - 1) * P;

  for (int k = 0; k < ns; ++k) {
    const T t = tau_b[k];
    const T growth = exp_(growth_rate * t);
    const T disc = exp_(-r * t);
    const T v_min_n = is_call ? T(0) : strike * disc - s_min * growth;
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
        T rhs = bc * v_cur + bl * v_prev + bu * v_next;
        if (ii == 0 && j == 0) rhs = rhs - al * v_min_n;
        if (j == P - 1) {
          if (ii == il) rhs = rhs + (bu * v_hi - au * v_max_n);
          else if (ii > il) rhs = T(0);  // pad rows
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
        const T xr = row[ri_] - bprev * vsp[ri_] - tnext * wsp[ri_];
        row[ri_] = (mon_k && om[ri_] != T(0)) ? rebate_pv : xr;
      }
    }
    v_lo = (mon_k && omask_lo) ? rebate_pv : v_min_n;
    v_hi = (mon_k && omask_hi) ? rebate_pv : v_max_n;
  }

  if (act)
    for (int ii = 0; ii < m; ++ii) v_out[base + ii * P + j] = row[ii * P + j];
  if (lane == 0) {
    edge_out[2 * b] = v_lo;
    edge_out[2 * b + 1] = v_hi;
  }
}

template <typename T>
int launch(const void* trade, const void* coef, const void* fields,
           const void* rinv, const void* omask, const void* tau,
           const void* mon, const void* v_in, const void* edge_in,
           void* v_out, void* edge_out, int B, int n_pad, int m, int P,
           int il, int k0, int ns, int n_sched, void* stream) {
  if (B <= 0 || P < 1 || P > 32 || m < 1 || n_pad != m * P || ns < 1 ||
      k0 < 0 || k0 + ns > n_sched || il < 0 || il >= m)
    return (int)cudaErrorInvalidValue;
  const size_t per_trade = (size_t)n_pad * sizeof(T);
  int tpb = kTradesPerBlock;
  while (tpb > 1 && tpb * per_trade > kMaxSmem) tpb /= 2;
  const size_t smem = tpb * per_trade;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spike_march_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + tpb - 1) / tpb);
  spike_march_kernel<T><<<grid, 32 * tpb, smem, (cudaStream_t)stream>>>(
      (const T*)trade, (const T*)coef, (const T*)fields, (const T*)rinv,
      (const T*)omask, (const T*)tau, (const T*)mon, (const T*)v_in,
      (const T*)edge_in, (T*)v_out, (T*)edge_out, B, n_pad, m, P, il, k0, ns,
      n_sched);
  return (int)cudaGetLastError();
}

}  // namespace

#define SPIKE_MARCH_ARGS                                                     \
  const void *trade, const void *coef, const void *fields, const void *rinv, \
      const void *omask, const void *tau, const void *mon, const void *v_in, \
      const void *edge_in, void *v_out, void *edge_out, int B, int n_pad,    \
      int m, int P, int il, int k0, int ns, int n_sched, void *stream
#define SPIKE_MARCH_CALL                                                     \
  trade, coef, fields, rinv, omask, tau, mon, v_in, edge_in, v_out, edge_out, \
      B, n_pad, m, P, il, k0, ns, n_sched, stream

extern "C" {

int spike_march_f32(SPIKE_MARCH_ARGS) { return launch<float>(SPIKE_MARCH_CALL); }

int spike_march_f64(SPIKE_MARCH_ARGS) { return launch<double>(SPIKE_MARCH_CALL); }

const char* spike_march_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

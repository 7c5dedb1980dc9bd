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
// Mapping (template parameter W, warps per trade). W = 1 for P <= 32: one
// warp per trade, lane j < P walks chunk j; four trades per block. W = P/32
// for P = 64 and 128: one trade per block of W warps, chunk j = 32*warp +
// lane (see "Several warps per trade" below). A trade's shared memory holds,
// for the whole launch:
//   - the value row (n_pad values); the forward-sweep scratch `dp` aliases
//     it in place, because lane j reads only its own chunk once the two
//     cross-chunk neighbours of a step are captured, and each row is
//     consumed before its slot is overwritten;
//   - American only: the lambda row (n_pad values; lane j reads and writes
//     only its own chunk's);
//   - the solver data, loaded once per launch with coalesced reads: the
//     five per-row vectors w, af, ab, vsp, wsp in their two columns (the
//     prep's (5, 2, m), stored here as [field][ii][column] so that the
//     shared column, a broadcast to lanes 0..P-2, and lane P-1's own column
//     sit in adjacent banks), and the eight factors of the banded interface
//     solve per pair (spike.IFACE_ROWS).
// A step reads from global memory only tau and the monitor flag, and in the
// American branch the payoff (segment-constant, 4 KB per trade at f32 and
// N=1024, 16.7 MB for B=4096: it stays in the 50 MB L2; holding it in
// shared memory instead would cut the resident trades from 20 to 12 per SM).
// The knock-out rows are a prefix and a suffix of the grid: two indices per
// trade in `trade`, compared with the global row g = j*m + ii.
//
// Interface solve. The pairs z_j = (b_j, t_{j+1}) form a block-tridiagonal
// system whose couplings have rank one, so its block LU (precomputed at
// float64 by spike.interface_factors) leaves two first-order recurrences
// across the lanes: hb_j = a_j hb_{j-1} + c_j upwards, then
// zt_j = a'_j zt_{j+1} + ht_j downwards. Each runs as a Kogge-Stone scan of
// affine maps over the warp (5 shuffle stages); a serial pass through the
// P-1 pairs was measured slower (PERF.md). spike.spike_march_reference
// follows the scan's order.
// Nothing in the march is a matrix product, so it uses no tensor cores.
//
// Several warps per trade (W > 1). A small batch (spike.spike_p: P=64 for
// at most 2048 trades) leaves the card short of warps at one warp per
// trade: the f64
// rung's 256 trades made 64 blocks of 4 warps on 132 SMs, and each step
// walked m = 32 rows three times through dependent f64 FMAs and
// shared-memory loads (latency, not issue rate, bounds it). At W warps per
// trade the chain per step is m = 8 or 16 rows and 256 trades fill all SMs.
// The exchanges that cross a warp's edge go through a few values per warp
// of shared memory after a block barrier, five per step:
//   1. the chunk neighbours' edge rows (each lane keeps its chunk's first
//      and last row in registers from the previous step's correction; the
//      lanes beside it give them by shuffle, the warps beside it through
//      shared memory);
//   2. y_top of chunk j+1 across the warp's upper edge;
//   3. and 4. each scan runs over the warp's 32 lanes, whose last (first)
//      lane then publishes the warp's composed map; each warp composes the
//      at most 3 maps before (after) it into the value entering it, which
//      is also hb_{j-1} (t_{j+1}) across the warp's edge;
//   5. b_{j-1} across the warp's lower edge.
// spike.interface_solve runs the same order: 32-lane scans, then the carry.
// Each lane touches only its own chunk's rows, so no other barrier is
// needed. W = 1 keeps the one-warp code path unchanged (if constexpr). On
// one NVIDIA H100 80GB HBM3 (700 W) the f64 American march of 256 trades
// at N=1024 takes 2.0 ms at P=128, 3.4 ms at P=64 and 5.9 ms at P=32
// (chip_smoke.py).
//
// American branch (Ikonen-Toivanen). Per step: the rhs is written in
// row-sum form, bsum*v + bl*(v_prev - v) + bu*(v_next - v) with
// bsum = 1 - (1-theta)*dt*r from the host (equal to bc*v + bl*v_prev +
// bu*v_next in exact arithmetic; at the American grid's dt/dx^2 rounding bc
// to float keeps only ~90% of the discount term, see spike_march_reference),
// it gains dt*lambda, and after the spike correction
// v = max(payoff, x - dt*lambda), lambda = max(0, lambda + (payoff - x)/dt)
// with a true division (the plain version divides too). dt is the sixth
// coefficient column. On a pad row payoff = lambda = x = 0, so the update
// keeps it 0. The put's lower edge is K e^{-r tau}. Every American addition
// is behind `if constexpr`.
//
// Bound. Per interior node and step about 14 flops (rhs 5, forward 3,
// backward 2, correction 4), 23 in the American branch, plus the banded
// interface solve: at B=4096, N=1024, 512 steps and P=32 about 3.1e10 flops,
// 0.47 ms at the published 67 TFLOP/s f32, against about 0.1 ms for the
// bytes the march must move. With no per-step stream of solver data left,
// what limits this design is the rate at which the SMs dispatch its
// instructions: each row of a step costs shared-memory loads and stores,
// index arithmetic and the edge and pad rows' branches beside its ~14 flops,
// by count about 30 warp instructions per row and 1,000 per trade-step, and
// the measured 5.0 ms per march (B=4096, PERF.md) implies about twice that
// if dispatch is the limit; a warp-per-trade march cannot come near the flop
// bound. The launch bounds keep the European f32 kernel at <= 64 registers
// so that 8 blocks (32 trades) are resident per SM, one wave for B=4096 on
// 132 SMs. The American f32 kernel's two rows and its solver data take 10.25
// KiB of shared memory per trade at N=1024, so 20 trades are resident per SM
// and B=4096 takes two waves: 32 trades would need 328 KiB of the SM's 228
// KiB, and lambda in registers 32 more per thread than the 64 that 32
// resident warps allow.
//
// Precise math only: expf/exp, no --use_fast_math. nvcc contracts a*b+c into
// FMA by default, which is why f32 results differ from the plain version at
// the rounding level.

#include <cuda_runtime.h>

namespace {

constexpr int kTradeCols = 13;  // spike.TRADE_COLS
constexpr int kCoefCols = 7;    // spike.COEF_COLS
constexpr int kFieldRows = 5;   // spike.FIELD_ROWS
constexpr int kIfaceRows = 8;   // spike.IFACE_ROWS
constexpr int kTradesPerBlock = 4;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use
constexpr unsigned kFull = 0xffffffffu;

constexpr int kXchRows = 8;  // W > 1: values per warp exchanged across warps

// blocks per SM the launch bounds ask registers for. W = 1: what shared
// memory allows at N=1024, the main path's width (f32 European 8, American
// 5; f64 4 and 2 blocks of 4 warps). Tuned to that width: at other N the
// shared-memory limit differs, so re-derive these when the main width
// changes. W > 1 asks for the same resident warps per SM as W = 1
// (4/W times the blocks), so the same register cap per thread: 64 for f32
// European, 102 for f32 American, 128 and 255 at f64. Shared memory is not
// the limit there (one trade per block, 6.8 to 25 KB at N=1024), and a
// batch that takes W > 1 fills the card with fewer warps than that.
template <int W>
constexpr int kThreads = 32 * (W == 1 ? kTradesPerBlock : W);

template <typename T, bool American, int W>
constexpr int kMinBlocks =
    (sizeof(T) == 4 ? (American ? 5 : 8) : (American ? 2 : 4)) * 32 * kTradesPerBlock / kThreads<W>;

__host__ __device__ inline int trade_smem_elems(bool american, int n_pad, int m, int P) {
  return n_pad * (american ? 2 : 1) + kFieldRows * 2 * m + kIfaceRows * P;
}

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T max_(T a, T b) { return a > b ? a : b; }

// x_j = a_j x_{j-1} + b_j across the lanes (x_{-1} = 0): inclusive scan;
// (a, b) become lane j's map composed with those of the lanes below it
template <typename T>
__device__ __forceinline__ void scan_up(T& a, T& b, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T a_l = __shfl_up_sync(kFull, a, off);
    const T b_l = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      b = a * b_l + b;
      a = a * a_l;
    }
  }
}

// x_j = a_j x_{j+1} + b_j across the lanes (x_32 = 0): inclusive scan down
template <typename T>
__device__ __forceinline__ void scan_down(T& a, T& b, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T a_r = __shfl_down_sync(kFull, a, off);
    const T b_r = __shfl_down_sync(kFull, b, off);
    if (lane + off < 32) {
      b = a * b_r + b;
      a = a * a_r;
    }
  }
}

template <typename T, bool American, int W>
__global__ void __launch_bounds__(kThreads<W>, (kMinBlocks<T, American, W>))
spike_march_kernel(
    const T* __restrict__ trade,   // (B, 13)
    const T* __restrict__ coef,    // (B, 7) bl, bc, bu, al, au, dt, bsum
    const T* __restrict__ fields,  // (B, 5, 2, m): spike.FIELD_ROWS x column
    const T* __restrict__ iface,   // (B, 8, P): spike.IFACE_ROWS x pair
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
  // W = 1: four trades per block, one per warp; W > 1: one trade per block
  const int b = W == 1 ? blockIdx.x * (blockDim.x >> 5) + warp : blockIdx.x;
  if (b >= B) return;  // ragged last block: whole warps drop out
  const int wv = W == 1 ? 0 : warp;  // the warp within the trade
  T* __restrict__ row = reinterpret_cast<T*>(smem_raw) +
                        (W == 1 ? (size_t)warp * trade_smem_elems(American, n_pad, m, P) : 0);
  T* __restrict__ lam = row + n_pad;                      // American only
  T* __restrict__ fs = row + n_pad * (American ? 2 : 1);  // [field][ii][column]
  T* __restrict__ fz = fs + kFieldRows * 2 * m;           // [factor][pair]
  // W > 1: kXchRows x W values exchanged across the trade's warps
  T* __restrict__ xch = fz + kIfaceRows * P;
  const bool act = W > 1 || lane < P;
  const int j = 32 * wv + lane;
  // the loads of the segment's data: a warp (W = 1) or the whole block
  const int tid = W == 1 ? lane : (int)threadIdx.x;
  constexpr int kLoaders = 32 * W;

  const T* tr = trade + (size_t)b * kTradeCols;
  const T strike = tr[0], r = tr[2], growth_rate = tr[3];
  const T rebate = tr[4], rebate_rate = tr[6], s_min = tr[7], s_max = tr[8];
  const bool is_call = tr[1] != T(0), at_hit = tr[5] != T(0);
  const bool omask_lo = tr[9] != T(0), omask_hi = tr[10] != T(0);
  // knocked-out rows of this lane's chunk: ii < ko_lo_j, and
  // ko_hi_j <= ii < real_j (the chunk's real rows end at real_j)
  const int g0 = j * m;
  const int ko_lo_j = (int)tr[11] - g0, ko_hi_j = (int)tr[12] - g0;
  const int real_j = (P - 1) * m + il + 1 - g0;
  const T* cf = coef + (size_t)b * kCoefCols;
  const T bl = cf[0], bc = cf[1], bu = cf[2], al = cf[3], au = cf[4];
  const T dt = cf[5], bsum = cf[6];  // read by the American branch only

  const size_t base = (size_t)b * n_pad;
  const T* __restrict__ tau_b = tau + (size_t)b * n_sched + k0;
  const T* __restrict__ mon_b = mon + (size_t)b * n_sched + k0;
  const T* __restrict__ pay = American ? payoff + base : nullptr;

  // segment-constant solver data into shared memory, once per launch
  const T* __restrict__ f_src = fields + (size_t)b * kFieldRows * 2 * m;
  for (int i = tid; i < kFieldRows * 2 * m; i += kLoaders) {
    const int fld = i / (2 * m), rem = i - fld * 2 * m;
    const int c = rem >= m ? 1 : 0;
    fs[(fld * m + rem - c * m) * 2 + c] = f_src[i];
  }
  const T* __restrict__ z_src = iface + (size_t)b * kIfaceRows * P;
  for (int i = tid; i < kIfaceRows * P; i += kLoaders) fz[i] = z_src[i];
  if (act)
    for (int ii = 0; ii < m; ++ii) row[ii * P + j] = v_in[base + ii * P + j];
  if constexpr (American) {
    if (act)
      for (int ii = 0; ii < m; ++ii) lam[ii * P + j] = lam_in[base + ii * P + j];
  }
  // this lane's column: the shared one, or chunk P-1's own
  const T* __restrict__ fw = fs + (j == P - 1 ? 1 : 0);
  const T* __restrict__ faf = fw + 2 * m;
  const T* __restrict__ fab = fw + 4 * m;
  const T* __restrict__ fvs = fw + 6 * m;
  const T* __restrict__ fws = fw + 8 * m;
  T v_lo = edge_in[2 * b], v_hi = edge_in[2 * b + 1];
  const int last = (m - 1) * P;
  // W > 1: this chunk's first and last rows, kept in registers from step to
  // step; the warp's edge lanes publish theirs for the warps beside it
  T my_first = T(0), my_last = T(0);
  if constexpr (W > 1) {
    my_first = row[j];
    my_last = row[last + j];
    if (lane == 0) xch[wv] = my_first;
    if (lane == 31) xch[W + wv] = my_last;
  }

  for (int k = 0; k < ns; ++k) {
    const T t = tau_b[k];
    const T growth = exp_(growth_rate * t);
    const T disc = exp_(-r * t);
    T v_min_put = strike * disc;
    if constexpr (!American) v_min_put = v_min_put - s_min * growth;
    const T v_min_n = is_call ? T(0) : v_min_put;
    const T v_max_n = is_call ? s_max * growth - strike * disc : T(0);

    T v_prev = T(0), v_cur = T(0), up_fix = T(0);
    if constexpr (W == 1) {
      // the two cross-chunk neighbours of this step, captured before any
      // lane overwrites its rows with the forward-sweep values (the first
      // step's __syncwarp also publishes the loads above)
      __syncwarp();
      if (act) {
        v_prev = j == 0 ? v_lo : row[last + j - 1];
        v_cur = row[j];
        up_fix = row[j + 1 < P ? j + 1 : 0];
      }
      __syncwarp();
    } else {
      // barrier 1: the edge rows the previous step (or the load) published
      __syncthreads();
      const T last_l = __shfl_up_sync(kFull, my_last, 1);
      const T first_r = __shfl_down_sync(kFull, my_first, 1);
      v_prev = lane > 0 ? last_l : (wv > 0 ? xch[W + wv - 1] : v_lo);
      v_cur = my_first;
      up_fix = lane < 31 ? first_r : xch[(wv + 1) % W];  // chunk 0's at j = P-1
    }

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
        d = ii == 0 ? fw[2 * ii] * rhs : fw[2 * ii] * rhs + faf[2 * ii] * d;
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
        x = row[ri_] + fab[2 * ii] * x;
        row[ri_] = x;
      }
    }
    const T y_top = x;

    // banded interface solve (spike.interface_solve): lane j < P-1 owns
    // pair z_j = (b_j, t_{j+1}); the factors are 0 on lanes >= P-1
    T zf[kIfaceRows];
#pragma unroll
    for (int q = 0; q < kIfaceRows; ++q) zf[q] = act ? fz[q * P + j] : T(0);
    T tnext, bprev;  // t_{j+1}, b_{j-1}
    if constexpr (W == 1) {
      const T yt_next = __shfl_down_sync(kFull, y_top, 1);
      T a = zf[0], hb = zf[1] * y_bot + zf[2] * yt_next;
      scan_up(a, hb, lane);
      const T hb_up = __shfl_up_sync(kFull, hb, 1);
      const T ht = zf[3] * (j == 0 ? T(0) : hb_up) + zf[4] * y_bot + zf[5] * yt_next;
      T a2 = zf[6];
      tnext = ht;
      scan_down(a2, tnext, lane);
      const T zb = hb + zf[7] * __shfl_down_sync(kFull, tnext, 1);  // b_j
      const T b_left = __shfl_up_sync(kFull, zb, 1);
      bprev = j == 0 ? T(0) : b_left;
    } else {
      T* __restrict__ x_top = xch + 2 * W;  // y_top of each warp's lane 0
      T* __restrict__ agg = xch + 3 * W;    // the warps' maps: a, b up; a, b down
      T* __restrict__ x_zb = xch + 7 * W;   // b_j of each warp's lane 31
      if (lane == 0) x_top[wv] = y_top;
      __syncthreads();  // barrier 2
      const T top_r = __shfl_down_sync(kFull, y_top, 1);
      const T yt_next = lane < 31 ? top_r : (wv + 1 < W ? x_top[wv + 1] : T(0));
      T a = zf[0], hb = zf[1] * y_bot + zf[2] * yt_next;
      scan_up(a, hb, lane);
      if (lane == 31) {
        agg[wv] = a;
        agg[W + wv] = hb;
      }
      __syncthreads();  // barrier 3
      // hb_{32 wv - 1}, the value entering this warp
      T carry = T(0);
      for (int v = 0; v < wv; ++v) carry = agg[v] * carry + agg[W + v];
      hb = a * carry + hb;
      const T hb_l = __shfl_up_sync(kFull, hb, 1);
      const T hb_up = lane > 0 ? hb_l : carry;  // 0 at j = 0
      const T ht = zf[3] * hb_up + zf[4] * y_bot + zf[5] * yt_next;
      T a2 = zf[6];
      tnext = ht;
      scan_down(a2, tnext, lane);
      if (lane == 0) {
        agg[2 * W + wv] = a2;
        agg[3 * W + wv] = tnext;
      }
      __syncthreads();  // barrier 4
      // t_{32 wv + 32}, the value entering this warp from above
      T carry2 = T(0);
      for (int v = W - 1; v > wv; --v) carry2 = agg[2 * W + v] * carry2 + agg[3 * W + v];
      tnext = a2 * carry2 + tnext;
      const T tn_r = __shfl_down_sync(kFull, tnext, 1);
      const T zb = hb + zf[7] * (lane < 31 ? tn_r : carry2);  // b_j
      if (lane == 31) x_zb[wv] = zb;
      __syncthreads();  // barrier 5
      const T b_left = __shfl_up_sync(kFull, zb, 1);
      bprev = lane > 0 ? b_left : (wv > 0 ? x_zb[wv - 1] : T(0));
    }

    // spike correction + knock-out projection with rebate PV
    const bool mon_k = mon_b[k] != T(0);
    const T rebate_pv = at_hit ? rebate : rebate * exp_(-rebate_rate * t);
    if (act) {
#pragma unroll 4
      for (int ii = 0; ii < m; ++ii) {
        const int ri_ = ii * P + j;
        T xr = row[ri_] - bprev * fvs[2 * ii] - tnext * fws[2 * ii];
        if constexpr (American) {
          const T lam_old = lam[ri_], p = pay[ri_];
          lam[ri_] = max_(lam_old + (p - xr) / dt, T(0));
          xr = max_(p, xr - dt * lam_old);
        }
        const bool ko = ii < ko_lo_j || (ii >= ko_hi_j && ii < real_j);
        row[ri_] = (mon_k && ko) ? rebate_pv : xr;
      }
    }
    if constexpr (W > 1) {
      my_first = row[j];
      my_last = row[last + j];
      if (lane == 0) xch[wv] = my_first;
      if (lane == 31) xch[W + wv] = my_last;
    }
    v_lo = (mon_k && omask_lo) ? rebate_pv : v_min_n;
    v_hi = (mon_k && omask_hi) ? rebate_pv : v_max_n;
  }

  // each lane writes its own chunk's rows
  if constexpr (W == 1) __syncwarp();
  if (act)
    for (int ii = 0; ii < m; ++ii) v_out[base + ii * P + j] = row[ii * P + j];
  if constexpr (American) {
    if (act)
      for (int ii = 0; ii < m; ++ii) lam_out[base + ii * P + j] = lam[ii * P + j];
  }
  if (j == 0) {
    edge_out[2 * b] = v_lo;
    edge_out[2 * b + 1] = v_hi;
  }
}

// trades per block and dynamic shared memory of a launch; false if even
// one trade per block does not fit. W > 1: one trade per block, with its
// exchange values.
template <typename T, bool American, int W>
bool config(int n_pad, int m, int P, int* tpb, size_t* smem) {
  const size_t per_trade =
      ((size_t)trade_smem_elems(American, n_pad, m, P) + (W > 1 ? kXchRows * W : 0)) * sizeof(T);
  int t = W == 1 ? kTradesPerBlock : 1;
  while (t > 1 && t * per_trade > kMaxSmem) t /= 2;
  *tpb = t;
  *smem = t * per_trade;
  return *smem <= kMaxSmem;
}

template <typename T, bool American, int W>
cudaError_t opt_in(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(spike_march_kernel<T, American, W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool American, int W>
int launch_w(const void* trade, const void* coef, const void* fields,
             const void* iface, const void* tau, const void* mon,
             const void* v_in, const void* edge_in, void* v_out, void* edge_out,
             const void* payoff, const void* lam_in, void* lam_out, int B,
             int n_pad, int m, int P, int il, int k0, int ns, int n_sched,
             void* stream) {
  int tpb;
  size_t smem;
  if (!config<T, American, W>(n_pad, m, P, &tpb, &smem)) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in<T, American, W>(smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + tpb - 1) / tpb);
  spike_march_kernel<T, American, W><<<grid, 32 * W * tpb, smem, (cudaStream_t)stream>>>(
      (const T*)trade, (const T*)coef, (const T*)fields, (const T*)iface,
      (const T*)tau, (const T*)mon, (const T*)v_in, (const T*)edge_in,
      (T*)v_out, (T*)edge_out, (const T*)payoff, (const T*)lam_in,
      (T*)lam_out, B, n_pad, m, P, il, k0, ns, n_sched);
  return (int)cudaGetLastError();
}

// P in [1, 32] runs one warp per trade; 64 and 128 run P/32 warps per trade
inline bool valid_p(int P) { return (P >= 1 && P <= 32) || P == 64 || P == 128; }

template <typename T, bool American>
int launch(const void* trade, const void* coef, const void* fields,
           const void* iface, const void* tau, const void* mon,
           const void* v_in, const void* edge_in, void* v_out, void* edge_out,
           const void* payoff, const void* lam_in, void* lam_out, int B,
           int n_pad, int m, int P, int il, int k0, int ns, int n_sched,
           void* stream) {
  if (B <= 0 || !valid_p(P) || m < 1 || n_pad != m * P || ns < 1 ||
      k0 < 0 || k0 + ns > n_sched || il < 0 || il >= m)
    return (int)cudaErrorInvalidValue;
  if (American && (payoff == nullptr || lam_in == nullptr || lam_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto run = P == 128 ? launch_w<T, American, 4>
                 : P == 64  ? launch_w<T, American, 2>
                            : launch_w<T, American, 1>;
  return run(trade, coef, fields, iface, tau, mon, v_in, edge_in, v_out, edge_out, payoff,
             lam_in, lam_out, B, n_pad, m, P, il, k0, ns, n_sched, stream);
}

template <typename T, bool American, int W>
int occupancy_w(int n_pad, int m, int P, int* trades_per_sm) {
  int tpb;
  size_t smem;
  if (!config<T, American, W>(n_pad, m, P, &tpb, &smem)) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in<T, American, W>(smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, spike_march_kernel<T, American, W>, 32 * W * tpb, smem);
  if (e != cudaSuccess) return (int)e;
  *trades_per_sm = blocks * tpb;
  return 0;
}

template <typename T, bool American>
int occupancy(int n_pad, int m, int P, int* trades_per_sm) {
  if (!valid_p(P) || m < 1 || n_pad != m * P) return (int)cudaErrorInvalidValue;
  const auto query = P == 128 ? occupancy_w<T, American, 4>
                   : P == 64  ? occupancy_w<T, American, 2>
                              : occupancy_w<T, American, 1>;
  return query(n_pad, m, P, trades_per_sm);
}

}  // namespace

#define SPIKE_MARCH_ARGS                                                       \
  const void *trade, const void *coef, const void *fields, const void *iface,  \
      const void *tau, const void *mon, const void *v_in, const void *edge_in, \
      void *v_out, void *edge_out, int B, int n_pad, int m, int P, int il,     \
      int k0, int ns, int n_sched, void *stream
#define SPIKE_MARCH_SHAPE B, n_pad, m, P, il, k0, ns, n_sched, stream
#define SPIKE_MARCH_IO \
  trade, coef, fields, iface, tau, mon, v_in, edge_in, v_out, edge_out

extern "C" {

int spike_march_f32(SPIKE_MARCH_ARGS) {
  return launch<float, false>(SPIKE_MARCH_IO, nullptr, nullptr, nullptr, SPIKE_MARCH_SHAPE);
}

int spike_march_f64(SPIKE_MARCH_ARGS) {
  return launch<double, false>(SPIKE_MARCH_IO, nullptr, nullptr, nullptr, SPIKE_MARCH_SHAPE);
}

// the American march: the European arguments followed by the payoff, lambda
// in and lambda out, each (B, n_pad)
int spike_march_american_f32(SPIKE_MARCH_ARGS, const void* payoff,
                             const void* lam_in, void* lam_out) {
  return launch<float, true>(SPIKE_MARCH_IO, payoff, lam_in, lam_out, SPIKE_MARCH_SHAPE);
}

int spike_march_american_f64(SPIKE_MARCH_ARGS, const void* payoff,
                             const void* lam_in, void* lam_out) {
  return launch<double, true>(SPIKE_MARCH_IO, payoff, lam_in, lam_out, SPIKE_MARCH_SHAPE);
}

// trades resident per SM for a launch of this shape
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times trades per block)
int spike_march_occupancy(int american, int f64, int n_pad, int m, int P,
                          int* trades_per_sm) {
  if (f64)
    return american ? occupancy<double, true>(n_pad, m, P, trades_per_sm)
                    : occupancy<double, false>(n_pad, m, P, trades_per_sm);
  return american ? occupancy<float, true>(n_pad, m, P, trades_per_sm)
                  : occupancy<float, false>(n_pad, m, P, trades_per_sm);
}

const char* spike_march_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

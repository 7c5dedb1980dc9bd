// Knock-in parity of a barrier request on the card, for Hopper (sm_90a).
//
// A knock-in trade is served as KI(R) = vanilla - KO(R at expiry) + R DF,
// its greeks likewise, with the vanilla leg's greeks from bumps of the
// generalized Black-Scholes price (serving/service.py `_apply_ki_parity`).
// Its plain PyTorch version is serving/service.py `ki_parity_reference`:
// one stacked `generalized_bs_price` over the bumps, then the parity rows.
//
// One thread per knock-in row. A thread reads its row's vanilla fields
// (spot, strike, sigma, t_expiry, r, b - q, is_call, rebate: one column of
// the (8, n) float64 `fields`) and its row j of the request, prices the
// evaluations that the present outputs need (the base price; s +- s 1e-4
// for delta and gamma; sigma + 1e-4 for vega; te +- min(1e-5, te/2) for
// theta), each on the branch is_call selects, and overwrites column j of
// the (K, B) float64 stack of the request's outputs: the knock-out leg's
// price and greeks in, the knock-in trade's out. Each output's row of the
// stack is given, -1 where the output is absent; a row j outside [0, B)
// is skipped. The stack then crosses to the host in one copy with every
// other row.
//
// Rounding. Every operation is the plain version's, in its order, rounded
// once: products, sums and quotients are written as __dmul_rn, __dadd_rn,
// __dsub_rn and __ddiv_rn so that nvcc contracts none of them into an FMA
// (PyTorch runs each as its own elementwise kernel), `c / x` is a
// reciprocal times c (PyTorch's Tensor.__rtruediv__), and exp, log and
// sqrt are CUDA's double functions, as PyTorch's kernels call them. The
// vanilla values then equal the plain version's on the card bit for bit.
//
// Bound. Up to six prices a row, each two exponentials, a logarithm, a
// square root and two normal CDFs: about 1,000 FP64 operations a row,
// 1e6 at 960 rows, microseconds against the launch's own cost. The launch
// replaces about 1,900 small PyTorch operations, six host copies and six
// synchronisations a request.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the rows of `fields` (service.KI_FIELDS)
enum { kSpot, kStrike, kSigma, kExpiry, kRate, kCarry, kCall, kRebate };

constexpr int kThreads = 128;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }

// ops/special.norm_cdf: Hart's rationals (|x| < 7.07...), the continued
// fraction beyond, 0 past 37; only the branch |x| selects is computed
__device__ double norm_cdf(double x) {
  const double xa = fabs(x);
  const double e = exp(mul(mul(xa, -0.5), xa));
  double cum;
  if (xa < 7.07106781186547) {
    double num = add(mul(xa, 3.52624965998911e-2), 0.700383064443688);
    num = add(mul(num, xa), 6.37396220353165);
    num = add(mul(num, xa), 33.912866078383);
    num = add(mul(num, xa), 112.079291497871);
    num = add(mul(num, xa), 221.213596169931);
    num = add(mul(num, xa), 220.206867912376);
    double den = add(mul(xa, 8.83883476483184e-2), 1.75566716318264);
    den = add(mul(den, xa), 16.064177579207);
    den = add(mul(den, xa), 86.7807322029461);
    den = add(mul(den, xa), 296.564248779674);
    den = add(mul(den, xa), 637.333633378831);
    den = add(mul(den, xa), 793.826512519948);
    den = add(mul(den, xa), 440.413735824752);
    cum = quo(mul(e, num), den);
  } else {
    double build = add(xa, 0.65);
    build = add(xa, mul(__drcp_rn(build), 4.0));
    build = add(xa, mul(__drcp_rn(build), 3.0));
    build = add(xa, mul(__drcp_rn(build), 2.0));
    build = add(xa, mul(__drcp_rn(build), 1.0));
    cum = quo(e, mul(build, 2.506628274631000502));
  }
  if (xa > 37.0) cum = 0.0;
  return x > 0.0 ? sub(1.0, cum) : cum;
}

// models/analytic/black_scholes.generalized_bs_price on one branch
__device__ double vanilla(double s, double k, double sig, double te, double r, double b,
                          bool call) {
  const double forward = mul(s, exp(mul(b, te)));
  const double df = exp(mul(-r, te));
  if (!(te > 0.0 && sig > 0.0)) {  // discounted intrinsic
    const double intrinsic = call ? sub(forward, k) : sub(k, forward);
    return mul(df, intrinsic > 0.0 ? intrinsic : 0.0);
  }
  const double t = te < 1e-300 ? 1e-300 : te;
  const double sg = sig < 1e-300 ? 1e-300 : sig;
  const double sig_sqrt = mul(sg, __dsqrt_rn(t));
  const double d1 = quo(add(log(quo(forward, k)), mul(mul(mul(sg, 0.5), sg), t)), sig_sqrt);
  const double d2 = sub(d1, sig_sqrt);
  if (call) return mul(df, sub(mul(forward, norm_cdf(d1)), mul(k, norm_cdf(d2))));
  return mul(df, sub(mul(k, norm_cdf(-d2)), mul(forward, norm_cdf(-d1))));
}

__global__ void __launch_bounds__(kThreads)
    ki_parity_kernel(const double* __restrict__ fields, const int64_t* __restrict__ rows,
                     double* __restrict__ stack, int n, int B, int r_price, int r_delta,
                     int r_gamma, int r_vega, int r_theta) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const double s = fields[kSpot * n + i];
  const double k = fields[kStrike * n + i];
  const double sig = fields[kSigma * n + i];
  const double te = fields[kExpiry * n + i];
  const double r = fields[kRate * n + i];
  const double b = fields[kCarry * n + i];
  const bool call = fields[kCall * n + i] != 0.0;
  const double rebate = fields[kRebate * n + i];
  const int64_t j = rows[i];
  if (j < 0 || j >= B) return;
  double* const price = stack + (int64_t)r_price * B + j;

  const double van = vanilla(s, k, sig, te, r, b, call);
  const double df = exp(mul(-r, te));
  *price = add(sub(van, *price), mul(rebate, df));
  if (r_delta >= 0 || r_gamma >= 0) {
    const double ds = mul(s, 1e-4);
    const double up = vanilla(add(s, ds), k, sig, te, r, b, call);
    const double dn = vanilla(sub(s, ds), k, sig, te, r, b, call);
    if (r_delta >= 0) {
      double* const delta = stack + (int64_t)r_delta * B + j;
      *delta = sub(quo(sub(up, dn), mul(ds, 2.0)), *delta);
    }
    if (r_gamma >= 0) {
      double* const gamma = stack + (int64_t)r_gamma * B + j;
      *gamma = sub(quo(add(sub(up, mul(van, 2.0)), dn), mul(ds, ds)), *gamma);
    }
  }
  if (r_vega >= 0) {
    const double dsig = 1e-4;
    double* const vega = stack + (int64_t)r_vega * B + j;
    const double bumped = vanilla(s, k, add(sig, dsig), te, r, b, call);
    *vega = sub(quo(sub(bumped, van), mul(100.0, dsig)), *vega);
  }
  if (r_theta >= 0) {
    // theta = dV/dt (valuation time) = -dV/dT; d(R DF)/dt = r R DF
    const double half = mul(te, 0.5);
    const double dte = half > 1e-5 ? 1e-5 : half;
    const double later = vanilla(s, k, sig, add(te, dte), r, b, call);
    const double sooner = vanilla(s, k, sig, sub(te, dte), r, b, call);
    double* const theta = stack + (int64_t)r_theta * B + j;
    const double v_theta = quo(-sub(later, sooner), mul(dte, 2.0));
    *theta = add(sub(v_theta, *theta), mul(mul(r, rebate), df));
  }
}

}  // namespace

extern "C" {

// overwrite the knock-in columns `rows` (n, int64) of the (K, B) float64
// stack from the (8, n) float64 `fields`; r_* name each output's row of
// the stack, -1 where absent
int ki_parity_f64(const void* fields, const void* rows, void* stack, int n, int B, int r_price,
                  int r_delta, int r_gamma, int r_vega, int r_theta, void* stream) {
  if (n <= 0 || B <= 0 || r_price < 0) return (int)cudaErrorInvalidValue;
  ki_parity_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)fields, (const int64_t*)rows, (double*)stack, n, B, r_price, r_delta,
      r_gamma, r_vega, r_theta);
  return (int)cudaGetLastError();
}

const char* ki_parity_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

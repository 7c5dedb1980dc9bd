// Native host-side batch builder for the CN barrier sweep path.
//
// The framework's device kernels consume fixed-shape struct-of-arrays
// batches; canonicalising a large scenario table (per-trade log grids +
// time schedules) is pure host work and the per-trade Python loop in
// models/pde/batch.build_trade_batch becomes the bottleneck for 100k+
// scenario sweeps. This C++ implementation reproduces the grid policy of
// grid.barrier_log_grid (the reference's choose_grid_parameters,
// discrete_barrier_fdm_pricer.py:270-340) and grid.uniform_schedule
// (discrete_barrier_fdm_pricer.py:442-547) bit-compatibly, writing straight
// into caller-allocated numpy buffers.
//
// The PyTorch port's own copy of finite_difference_tpu/native/fd_native.cpp
// (the port imports nothing of the JAX package). It differs in these header
// lines and in one split: the JAX package's american_batch is here two
// entries, american_grids and american_schedules, so that a builder
// computes each distinct schedule once; the arithmetic is the same
// expressions in the same order. Built with the same flags, so the two
// libraries agree bit for bit:
// g++ -O3 -shared -fPIC -std=c++17 fd_native.cpp -o libfdnative.so
// Loaded via ctypes (finite_difference_tpu_torch.native).

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <utility>
#include <vector>

namespace {
constexpr double PPF_99999 = 4.264890793922602;  // Phi^{-1}(0.99999)
}

extern "C" {

// Per-trade barrier log-grid policy. Arrays length B; barriers use
// has_lower/has_upper flags (levels ignored when flag is 0).
// Outputs: x_min, dx (length B).
void barrier_log_grids(
    const double* spot_eff, const double* strike, const double* sigma,
    const double* t_expiry,
    const double* lower, const double* upper,
    const uint8_t* has_lower, const uint8_t* has_upper,
    int64_t batch, int64_t num_space_nodes,
    double* x_min_out, double* dx_out) {
  for (int64_t i = 0; i < batch; ++i) {
    double s_low = std::min(spot_eff[i], strike[i]);
    double s_high = std::max(spot_eff[i], strike[i]);
    if (has_lower[i] && lower[i] > 0.0) {
      s_low = std::min(s_low, lower[i]);
      s_high = std::max(s_high, lower[i]);
    }
    if (has_upper[i] && upper[i] > 0.0) {
      s_low = std::min(s_low, upper[i]);
      s_high = std::max(s_high, upper[i]);
    }
    const double sqrt_t = std::sqrt(std::max(t_expiry[i], 1e-12));
    const double domain_width = 2.0 * PPF_99999 * sigma[i] * sqrt_t;
    const double x_c = std::log(std::sqrt(s_low * s_high));
    double s_min = std::exp(x_c - 0.5 * domain_width);
    double s_max = std::exp(x_c + 0.5 * domain_width);
    s_min = std::max(std::min(s_min, 0.5 * s_low), 1e-12);
    s_max = std::max(s_max, 2.0 * s_high);
    const double x_min = std::log(s_min);
    const double x_max = std::log(s_max);
    x_min_out[i] = x_min;
    dx_out[i] = (x_max - x_min) / static_cast<double>(num_space_nodes);
  }
}

// Per-trade uniform time schedules (constant dt = T/n, Rannacher theta=1 on
// the first `rannacher` steps near expiry, KO monitor flags mapped with
// k = floor((T - t_mon)/dt + 1e-9) clamped to [1, n]).
//
// monitor_times is flattened ragged storage: trade i owns
// monitor_times[mon_offsets[i] .. mon_offsets[i+1]).
// Outputs are (B, n_steps) row-major: dt, theta, tau_next; monitor uint8.
void uniform_schedules(
    const double* t_expiry, int64_t batch, int64_t n_steps, int64_t rannacher,
    const double* monitor_times, const int64_t* mon_offsets,
    double* dt_out, double* theta_out, double* tau_next_out,
    uint8_t* monitor_out) {
  for (int64_t i = 0; i < batch; ++i) {
    const double T = t_expiry[i];
    const double dt = T / static_cast<double>(n_steps);
    double* dt_row = dt_out + i * n_steps;
    double* th_row = theta_out + i * n_steps;
    double* tau_row = tau_next_out + i * n_steps;
    uint8_t* mon_row = monitor_out + i * n_steps;
    for (int64_t k = 0; k < n_steps; ++k) {
      dt_row[k] = dt;
      th_row[k] = (k < rannacher) ? 1.0 : 0.5;
      tau_row[k] = dt * static_cast<double>(k + 1);
      mon_row[k] = 0;
    }
    for (int64_t m = mon_offsets[i]; m < mon_offsets[i + 1]; ++m) {
      const double t_mon = monitor_times[m];
      if (t_mon <= 0.0 || t_mon > T) continue;
      const double tau_mon = T - t_mon;
      int64_t k = static_cast<int64_t>(std::floor(tau_mon / dt + 1e-9));
      k = std::max<int64_t>(1, std::min<int64_t>(n_steps, k));
      mon_row[k - 1] = 1;
    }
  }
}

// Per-trade American grids (grid.american_log_grid, which mirrors the
// reference's fd_american_equity.py layout). Bit-compatible with the Python
// loop: scalar libm exp/log (same symbols math.exp binds), and
// std::nearbyint under the default FE_TONEAREST mode reproduces Python's
// round-half-to-even. When `snap` is nonzero, spot/strike are snapped onto
// grid nodes (the scalar pricer's payoff-kink-on-node policy) and written
// to spot_out/strike_out; otherwise the inputs pass through unchanged.
void american_grids(
    const double* spot, const double* strike, const double* sigma,
    const double* t_expiry, int64_t batch, int64_t num_space_nodes,
    double s_max_mult, uint8_t snap,
    double* x_min_out, double* dx_out, double* spot_out, double* strike_out) {
  for (int64_t i = 0; i < batch; ++i) {
    const double T = t_expiry[i];
    double sp = spot[i];
    double st = strike[i];

    const double s_low = std::min(sp, st);
    const double s_high = std::max(sp, st);
    const double s_c = std::sqrt(std::max(s_low * s_high, 1e-12));
    const double band = s_max_mult * sigma[i] * std::sqrt(std::max(T, 1e-12));
    const double x_c = std::log(s_c);
    double s_min = std::exp(x_c - 0.5 * band);
    double s_max = std::exp(x_c + 0.5 * band);
    s_min = std::max(std::min(s_min, 0.5 * s_low), 1e-8);
    s_max = std::max(s_max, 2.0 * s_high);
    const double x_min = std::log(s_min);
    const double dx = (std::log(s_max) - x_min) /
                      static_cast<double>(num_space_nodes);
    x_min_out[i] = x_min;
    dx_out[i] = dx;
    if (snap) {
      sp = std::exp(x_min + std::nearbyint((std::log(sp) - x_min) / dx) * dx);
      st = std::exp(x_min + std::nearbyint((std::log(st) - x_min) / dx) * dx);
    }
    spot_out[i] = sp;
    strike_out[i] = st;
  }
}

// Per-trade segmented dividend schedules (grid.segmented_schedule). Tau
// accumulates sequentially per segment, as in the Python loop.
//
// Dividends are flattened ragged storage: trade i owns div_tau/div_amt in
// [div_offsets[i], div_offsets[i+1]). restart_at_div is the per-trade
// "Rannacher restarts after each dividend" flag (calls in the American
// pricer).
//
// status_out[i]: 0 ok; 1 = segment steps exceeded n_steps (caller raises).
void american_schedules(
    const double* t_expiry, const uint8_t* restart_at_div,
    const double* div_tau, const double* div_amt, const int64_t* div_offsets,
    int64_t batch, int64_t n_steps, int64_t rannacher,
    double* dt_out, double* theta_out, double* tau_next_out,
    double* div_out, uint8_t* reset_out, int64_t* status_out) {
  std::vector<std::pair<double, double>> divs;
  std::vector<double> seg_len;
  std::vector<int64_t> seg_steps;
  for (int64_t i = 0; i < batch; ++i) {
    const double T = t_expiry[i];

    // segmented_schedule: open-interval filter + stable sort by tau
    divs.clear();
    for (int64_t d = div_offsets[i]; d < div_offsets[i + 1]; ++d) {
      if (div_tau[d] > 0.0 && div_tau[d] < T) {
        divs.emplace_back(div_tau[d], div_amt[d]);
      }
    }
    std::stable_sort(divs.begin(), divs.end(),
                     [](const std::pair<double, double>& a,
                        const std::pair<double, double>& b) {
                       return a.first < b.first;
                     });
    const int64_t m = static_cast<int64_t>(divs.size());
    seg_len.assign(m + 1, 0.0);
    double prev = 0.0;
    for (int64_t s = 0; s < m; ++s) {
      seg_len[s] = divs[s].first - prev;
      prev = divs[s].first;
    }
    seg_len[m] = T - prev;
    const double base_dt = T / static_cast<double>(n_steps);
    seg_steps.assign(m + 1, 0);
    int64_t remaining = n_steps;
    for (int64_t s = 0; s < m; ++s) {
      const int64_t n_seg = std::max<int64_t>(
          1, static_cast<int64_t>(std::nearbyint(seg_len[s] / base_dt)));
      seg_steps[s] = n_seg;
      remaining -= n_seg;
    }
    seg_steps[m] = std::max<int64_t>(1, remaining);

    double* dt_row = dt_out + i * n_steps;
    double* th_row = theta_out + i * n_steps;
    double* tau_row = tau_next_out + i * n_steps;
    double* div_row = div_out + i * n_steps;
    uint8_t* reset_row = reset_out + i * n_steps;
    int64_t pos = 0;
    double tau = 0.0;
    status_out[i] = 0;
    for (int64_t s = 0; s <= m && status_out[i] == 0; ++s) {
      const int64_t n_seg = seg_steps[s];
      const double seg_dt = seg_len[s] / static_cast<double>(n_seg);
      const bool restart = (s == 0) || (restart_at_div[i] != 0);
      for (int64_t k = 0; k < n_seg; ++k) {
        if (pos >= n_steps) {
          status_out[i] = 1;  // segment steps exceeded n_time_steps
          break;
        }
        dt_row[pos] = seg_dt;
        th_row[pos] = (restart && k < rannacher) ? 1.0 : 0.5;
        tau += seg_dt;
        tau_row[pos] = tau;
        div_row[pos] = (k == n_seg - 1 && s < m) ? divs[s].second : 0.0;
        reset_row[pos] = (k == 0) ? 1 : 0;
        ++pos;
      }
    }
    // defensive pad (mirrors build_american_batch's pad branch; unreachable
    // when the remainder rule lands exactly on n_steps)
    for (; pos < n_steps; ++pos) {
      dt_row[pos] = 0.0;
      th_row[pos] = 0.5;
      tau_row[pos] = tau;
      div_row[pos] = 0.0;
      reset_row[pos] = 0;
    }
    if (status_out[i] != 0) {
      for (int64_t k = 0; k < n_steps; ++k) {
        dt_row[k] = th_row[k] = tau_row[k] = div_row[k] = 0.0;
        reset_row[k] = 0;
      }
    }
  }
}

}  // extern "C"

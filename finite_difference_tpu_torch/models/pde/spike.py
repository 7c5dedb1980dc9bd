"""SPIKE (partitioned Thomas) Crank–Nicolson march for barrier and American batches.

Counterpart of the SPIKE part of ``finite_difference_tpu/models/pde/
pallas_kernel.py``: the host prep ``_per_row_thomas``, ``_chunk_solve`` and
``_build_solver_set``; ``cn_barrier_solve_spike`` (the body of
``_cn_barrier_solve_spike_jit``: segments, lambda resets and the dividend
jump between launches); and the Pallas kernel ``_kernel_spike``, both
branches, which here is the CUDA kernel ``csrc/spike_march.cu`` with
:func:`spike_march_reference` as its plain PyTorch version. At float64 the
same kernel, compiled at ``double``, takes the place of the TPU's
double-float kernel ``_kernel_spike_df64``: the H100 has native float64.

Each step's implicit tridiagonal solve splits the n_int interior rows
into P chunks of m rows. Each chunk runs its own Thomas chain; the
chunks are coupled through the 2P-unknown SPIKE interface system. That
system is banded: the pairs z_j = (b_j, t_{j+1}) form a
block-tridiagonal system with 2x2 blocks whose off-diagonal blocks have
rank one, so its block LU (:func:`interface_factors`, per segment
constant, computed here at float64) reduces a step's interface solve to
two first-order recurrences across the chunks (:func:`interface_solve`).
With ``american=True`` each step also carries the Ikonen–Toivanen
multiplier lambda: a ``dt*lambda`` source term in the right-hand side,
the projection ``max(payoff, v - dt*lambda)`` and the update ``lambda =
max(0, lambda + (payoff - v)/dt)``; lambda is threaded across segments.

Layout. Interior row g = j*m + ii (chunk j, in-chunk row ii) is stored
at position r = ii*P + j of a trade's (n_pad,) row, n_pad = m*P; trades
are the leading axis, so value rows are (B, n_pad). With P <= 32 a warp
holds one trade and lane j walks chunk j; with P = 64 or 128 a trade
takes P/32 warps and chunk j = 32*warp + lane. Rows g >= n_int are identity
pad rows pinned to 0, all in the tail of chunk P-1 (at least one exists
by the choice of m), so the global-last row's in-chunk upper neighbour
is always a zero pad and its boundary coupling is folded into the
right-hand side. On a pad row the payoff, lambda and the solve are all
0, so the American update keeps it 0.

Compressed solver data. The per-chunk tridiagonals depend on the chunk
only through the masks of real, lower- and upper-coupled rows, and those
are the same for every chunk j < P-1 (``spike_shape`` guarantees
(P-1)*m < n_int). So each per-row vector has two distinct columns of m
values: column 0, shared by chunks 0..P-2, and column 1, chunk P-1's own
(with the pads); :func:`expand_fields` gives the (B, m, P) rows back.
The knock-out mask is a prefix and a suffix of the monotone grid, so two
row indices per trade (``ko_lo``, ``ko_hi`` in ``trade``) describe it.

P is this port's own parameter, a rule of the grid and the batch size
(:func:`spike_p`): 32 for the 1024-node main path, and 64 for a batch of
at most 2048 trades on a fine grid, where one warp per trade would leave
the card's SMs short of warps, unless the interface guard refuses it
(:func:`prepare_spike`); P=128 runs when a caller asks for it. Unlike the
TPU kernel, P need not be a multiple of 8 and the batch need not be a
multiple of 128: the CUDA kernel masks a ragged last block.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import torch

from ... import kernels
from ...ops.interp import cubic_spline_eval, natural_cubic_spline
from .stepper import _payoff

P_CANDIDATES = (32, 16, 8)
# chunks of a trade that spans several warps (chunk j = 32*warp + lane)
P_WIDE = (64, 128)
LANES = 32
# spike_p's batch-size rule: a batch of at most WIDE_MAX_BATCH trades takes
# WIDE_P chunks, two warps per trade, on a grid whose chunks keep at least
# WIDE_MIN_ROWS rows. On an NVIDIA H100 80GB HBM3 (700 W) at N=1024, 512
# steps (chip_smoke.py's spike_p_rule lines, PERF.md), P=64 marched faster
# than P=32 at every batch of 256 to 2048 trades on the barrier set (f32)
# and the American set (f32, f64), the barrier set least (2.70 against 2.91
# ms at 2048; slower at 4096, where the one-warp kernel fills the card).
# P=128 marched faster still at small batches, but its prep's (P-1)-step
# pivot recurrence launches more host-driven kernels than the march saves,
# and its 8-row chunks couple the interface system more (largest tip row
# sum on the American rung set below 0.88, 0.90 and 0.94 at P = 32, 64 and
# 128, against the guard's limit of 1; tests/test_torch_spike_prep.py)
WIDE_P = 64
WIDE_MAX_BATCH = 2048
WIDE_MIN_ROWS = 8

# column order of SpikePrep.trade and SpikePrep.coef (the kernel reads the same)
# ko_lo: interior rows g < ko_lo are knocked out from below; ko_hi: rows
# ko_hi <= g < n_int from above (omask_lo/omask_hi: the two edge nodes)
TRADE_COLS = (
    "strike", "is_call", "r", "growth_rate", "rebate", "rebate_at_hit",
    "rebate_rate", "s_min", "s_max", "omask_lo", "omask_hi", "ko_lo", "ko_hi",
)
COEF_COLS = ("bl", "bc", "bu", "al", "au", "dt", "bsum")
FIELD_ROWS = ("w", "af", "ab", "vsp", "wsp")
# the banded interface solve's factors for pair j (interface_factors):
#   hb_j = hb_h*hb_{j-1} + hb_yb*y_bot_j + hb_yt*y_top_{j+1}
#   ht_j = ht_h*hb_{j-1} + ht_yb*y_bot_j + ht_yt*y_top_{j+1}
#   t_{j+1} = zt_j = zt_z*zt_{j+1} + ht_j,   b_j = zb_j = hb_j + zb_z*zt_{j+1}
IFACE_ROWS = ("hb_h", "hb_yb", "hb_yt", "ht_h", "ht_yb", "ht_yt", "zt_z", "zb_z")
# the least block-pivot determinant the interface elimination accepts (see
# interface_refusal)
DET_FLOOR = 1e-3


def spike_shape(n_nodes: int, P: int) -> Tuple[int, int, int]:
    """(n_int, m, n_pad) of the SPIKE partitioning; raises if it does not fit."""
    if not (1 <= P <= LANES or P in P_WIDE):
        raise ValueError(
            f"p_chunks must be in [1, 32] (one warp per trade) or 64 or 128 "
            f"(P/32 warps per trade): {P}"
        )
    n_int = n_nodes - 2
    m = -(-(n_int + 1) // P)  # >= 1 pad row after the last interior row
    n_pad = m * P
    if (P - 1) * m >= n_int:
        raise ValueError(f"grid too small for SPIKE partitioning: N={n_nodes}, P={P}")
    if n_pad - n_int > m:
        raise ValueError("pad rows spill outside the last chunk")
    return n_int, m, n_pad


def _fits(n_nodes: int, P: int) -> bool:
    try:
        _, m, _ = spike_shape(n_nodes, P)
    except ValueError:
        return False
    return P <= LANES or m >= WIDE_MIN_ROWS


def spike_p_choices(n_nodes: int, batch_size: int) -> Tuple[int, ...]:
    """The P that the rule may take for ``batch_size`` trades on
    ``n_nodes`` grids, first choice first: :data:`WIDE_P` for a batch of at
    most :data:`WIDE_MAX_BATCH` trades whose chunks keep at least
    :data:`WIDE_MIN_ROWS` rows, then the largest P in
    :data:`P_CANDIDATES` that partitions the grid (one warp per trade).
    Empty when no P partitions the grid."""
    wide = [WIDE_P] if batch_size <= WIDE_MAX_BATCH and _fits(n_nodes, WIDE_P) else []
    narrow = [P for P in P_CANDIDATES if _fits(n_nodes, P)]
    return tuple(wide + narrow[:1])


def spike_p(n_nodes: int, batch_size: int) -> Optional[int]:
    """The rule's first choice of P (:func:`spike_p_choices`), or None when
    no P partitions the grid: 32 for the main path (B=4096 at N=1024), 64
    for a batch of at most 2048 trades at N=1024. :func:`prepare_spike`
    with ``P=None`` takes it, unless the interface guard refuses a P of
    several warps: then it takes the one-warp P."""
    choices = spike_p_choices(n_nodes, batch_size)
    return choices[0] if choices else None


@dataclass
class SpikePrep:
    """The prepared tensors one SPIKE march reads (all on one device, one dtype).

    ``trade`` (B, 13) per-trade constants in :data:`TRADE_COLS` order
    (with the knock-out row indices); ``coef`` (S, B, 7) explicit/implicit
    CN coefficients, dt and the explicit row sum per solver set;
    ``fields`` (S, B, 5, 2, m) the :data:`FIELD_ROWS` per-row Thomas and
    spike vectors in their two columns (shared by chunks 0..P-2, and chunk
    P-1's own); ``iface`` (S, B, 8, P) the :data:`IFACE_ROWS` factors of
    the banded interface solve, per pair j < P-1 (column P-1 is zero);
    ``tau``/``mon`` (B, n_steps)
    schedule; ``v0`` (B, n_pad) payoff and ``edge0`` (B, 2) its edge values.
    ``american`` selects the Ikonen–Toivanen branch of the march, whose
    exercise target is ``v0`` (the payoff) in every segment, and the
    American put edge K e^{-r tau} (no S_min term).
    """

    trade: torch.Tensor
    coef: torch.Tensor
    fields: torch.Tensor
    iface: torch.Tensor
    tau: torch.Tensor
    mon: torch.Tensor
    v0: torch.Tensor
    edge0: torch.Tensor
    m: int
    P: int
    n_int: int
    il: int  # band ii holding the global-last interior row (in chunk P-1)
    american: bool = False

    def map_trades(self, fn) -> "SpikePrep":
        """This prep with ``fn(x, dim)`` applied to each tensor, ``dim`` its
        trade axis. Every tensor and the interface guard are per trade, so
        rows a:b of a batch's prep are the prep of its trades a:b."""
        return replace(self, **{
            name: fn(getattr(self, name), 1 if name in ("coef", "fields", "iface") else 0)
            for name in ("trade", "coef", "fields", "iface", "tau", "mon", "v0", "edge0")
        })


def _per_row_thomas(l, c, u):
    """(w, af, ab) for the per-chunk tridiagonals; all (B, m, K), K chunks or columns."""
    w = torch.empty_like(c)
    w_prev = torch.zeros_like(c[:, 0])
    u_prev = torch.zeros_like(c[:, 0])
    for ii in range(c.shape[1]):
        w[:, ii] = 1.0 / (c[:, ii] - l[:, ii] * u_prev * w_prev)
        w_prev, u_prev = w[:, ii], u[:, ii]
    return w, -l * w, -u * w


def _chunk_solve(w, af, ab, rhs):
    """Solve the per-chunk tridiagonals for (B, m, K) right-hand sides."""
    m = rhs.shape[1]
    y = torch.empty_like(rhs)
    d = torch.zeros_like(rhs[:, 0])
    for ii in range(m):
        d = w[:, ii] * rhs[:, ii] + af[:, ii] * d
        y[:, ii] = d
    x = torch.zeros_like(rhs[:, 0])
    for ii in range(m - 1, -1, -1):
        x = y[:, ii] + ab[:, ii] * x
        y[:, ii] = x
    return y


def expand_fields(fields, P: int):
    """The five (B, m, P) per-row vectors of compressed ``fields`` (B, 5, 2, m):
    column 0 for chunks 0..P-2, column 1 for chunk P-1, and chunk 0's vsp
    zero (it has no left coupling)."""
    col = torch.tensor([0] * (P - 1) + [1], device=fields.device)
    w, af, ab, vsp, wsp = fields.transpose(2, 3)[..., col].unbind(1)
    vsp = torch.cat([torch.zeros_like(vsp[..., :1]), vsp[..., 1:]], dim=-1)
    return w, af, ab, vsp, wsp


def interface_tips(fields, P: int):
    """The spike vectors' tips per chunk, (p, q, r, s) each (B, P):
    p_j = vsp_j[0], r_j = vsp_j[m-1], q_j = wsp_j[0], s_j = wsp_j[m-1], with
    p_0 = r_0 = 0 and q_{P-1} = s_{P-1} = 0. The interface system is
        t_j + p_j b_{j-1} + q_j t_{j+1} = y_top_j
        b_j + r_j b_{j-1} + s_j t_{j+1} = y_bot_j."""
    _, _, _, vsp, wsp = expand_fields(fields, P)
    return vsp[:, 0], wsp[:, 0], vsp[:, -1], wsp[:, -1]


def interface_factors(p, q, r, s):
    """Block LU of the reduced interface system: (iface (B, 8, P), det (B, P-1)).

    The unknowns pair as z_j = (b_j, t_{j+1}), j = 0..P-2, in a block
    tridiagonal system with diagonal blocks D_j = [[1, s_j], [p_{j+1}, 1]]
    and rank-one couplings r_j (to b_{j-1}) and q_{j+1} (to t_{j+2}). The
    elimination changes only D_j[0, 1], to s_j - r_j q_j Dinv_{j-1}[0, 1],
    and leaves two scalar recurrences across the pairs (see
    :data:`IFACE_ROWS`); t_0 and b_{P-1} are not needed by the correction.
    No pivoting: ``det`` is each eliminated block's determinant, which
    :func:`interface_refusal` holds above :data:`DET_FLOOR`.
    Exact (no truncation of far couplings).
    """
    # the only sequential part: D'_j[0, 1] through Dinv_{j-1}[0, 1]
    rq = r * q
    i01 = torch.zeros_like(p[:, 0])
    d01 = []
    for j in range(p.shape[1] - 1):
        d01.append(s[:, j] - rq[:, j] * i01)
        i01 = d01[-1] / (d01[-1] * p[:, j + 1] - 1.0)
    if not d01:  # P = 1: no pairs
        return p.new_zeros(p.shape[0], len(IFACE_ROWS), 1), p.new_zeros(p.shape[0], 0)
    d01 = torch.stack(d01, dim=1)  # (B, P-1)
    p_next, r_j, q_next = p[:, 1:], r[:, :-1], q[:, 1:]
    det = 1.0 - d01 * p_next
    i00, i01, i10 = 1.0 / det, -d01 / det, -p_next / det  # Dinv_j; [1, 1] = [0, 0]
    rows = [-i00 * r_j, i00, i01, -i10 * r_j, i10, i00, -i00 * q_next, -i01 * q_next]
    iface = torch.stack(rows, dim=1)
    return torch.cat([iface, torch.zeros_like(iface[:, :, :1])], dim=2), det


def interface_refusal(p, q, r, s, det) -> Optional[str]:
    """None when the interface elimination, which does not pivot, is safe
    for every trade, else why not: safe means the reduced system is strictly
    diagonally dominant by rows (|p_j| + |q_j| < 1 and |r_j| + |s_j| < 1;
    it is when A is, as when |mu|*dx <= sigma^2), so that elimination
    without pivoting is backward stable, and every block pivot's
    determinant is at least :data:`DET_FLOOR`, so that the factors, which
    grow like 1/det, amplify the float32 rounding of the tips (6e-8) to at
    most 6e-5, inside the kernel's 2e-4 float32 limit. Tips and ``det`` as
    :func:`interface_tips` and :func:`interface_factors` give them."""
    row_sum = torch.maximum(p.abs() + q.abs(), r.abs() + s.abs())
    bad = (row_sum >= 1.0).any(dim=1) | (det < DET_FLOOR).any(dim=1)
    if not bool(bad.any()):
        return None
    return (
        f"SPIKE interface elimination without pivoting is unsafe for "
        f"{int(bad.sum())} of {bad.numel()} trade solver sets at P={p.shape[1]}: "
        f"largest tip row sum {float(row_sum.max()):.3g} (must be < 1), least block "
        f"pivot determinant {float(det.min()) if det.numel() else 1.0:.3g} (must be "
        f">= {DET_FLOOR:g}); a drift-dominated trade (|mu|*dx > sigma^2) or "
        f"a coarse time grid does this; use solver='scan'"
    )


def _ks_up(a, b):
    """Inclusive Kogge–Stone scan of the affine maps x -> a_j x + b_j along
    the last axis, in the kernel's order: the composed maps (a, b)."""
    off = 1
    while off < a.shape[-1]:
        b = torch.cat([b[..., :off], a[..., off:] * b[..., :-off] + b[..., off:]], dim=-1)
        a = torch.cat([a[..., :off], a[..., off:] * a[..., :-off]], dim=-1)
        off *= 2
    return a, b


def _scan_up(a, b):
    """x_j = a_j x_{j-1} + b_j with x_{-1} = 0, for every j, in the
    kernel's order: an inclusive Kogge–Stone scan across the chunk axis
    within each warp's 32 chunks; for P > 32, each warp's value entering
    it (the carry) then composed from the warps before it, one at a time."""
    B, P = a.shape
    if P <= LANES:
        return _ks_up(a, b)[1]
    a, b = _ks_up(a.reshape(B, -1, LANES), b.reshape(B, -1, LANES))
    carry = torch.zeros_like(a[:, 0, 0])
    out = []
    for w in range(a.shape[1]):
        out.append(a[:, w] * carry[:, None] + b[:, w])
        carry = a[:, w, -1] * carry + b[:, w, -1]
    return torch.cat(out, dim=1)


def _scan_down(a, b):
    """x_j = a_j x_{j+1} + b_j with x_P = 0: the scan of :func:`_scan_up`
    on the reversed chunk axis, which is the kernel's downward order."""
    return _scan_up(a.flip(1), b.flip(1)).flip(1)


def interface_solve(iface, y_top, y_bot):
    """The banded interface solve of one step, in the kernel's order:
    (bprev, tnext) (B, P), chunk j's b_{j-1} and t_{j+1} (0 where they do
    not exist), from the chunk solves' tips y_top, y_bot (B, P)."""
    hb_h, hb_yb, hb_yt, ht_h, ht_yb, ht_yt, zt_z, zb_z = iface.unbind(1)
    col0 = torch.zeros_like(y_top[:, :1])
    up = lambda x: torch.cat([col0, x[:, :-1]], dim=1)  # lane j takes lane j-1's
    down = lambda x: torch.cat([x[:, 1:], col0], dim=1)  # lane j takes lane j+1's
    yt_next = down(y_top)
    hb = _scan_up(hb_h, hb_yb * y_bot + hb_yt * yt_next)
    ht = ht_h * up(hb) + ht_yb * y_bot + ht_yt * yt_next
    zt = _scan_down(zt_z, ht)
    zb = hb + zb_z * down(zt)
    return up(zb), zt


def ko_rows(prep: SpikePrep):
    """The knock-out mask (B, m, P) of the prep's interior rows, from the
    trade's two row indices; pads are never knocked out."""
    m, P = prep.m, prep.P
    ii = torch.arange(m, device=prep.trade.device)[:, None]
    g = torch.arange(P, device=prep.trade.device)[None, :] * m + ii
    ko_lo, ko_hi = (prep.trade[:, TRADE_COLS.index(k)][:, None, None] for k in ("ko_lo", "ko_hi"))
    return (g < ko_lo) | ((g >= ko_hi) & (g < prep.n_int))


def _build_solver_sets(theta, dt, r, a_coef, b_coef, c_coef, has_l, has_u, real, m, P):
    """Every (theta, dt) solver set at once, theta (S, 1) and dt (S, B):
    ((coef (S, B, 7), fields (S, B, 5, 2, m), iface (S, B, 8, P)), None),
    or (None, the interface guard's refusal).

    ``has_l``, ``has_u`` and ``real`` are the (m, 2) row masks of the two
    columns. The interface factors replace the dense 2P x 2P inverse that
    JAX computes with ``jnp.linalg.inv`` outside Pallas.
    """
    S, B = dt.shape
    a_l = -theta * dt * a_coef
    a_c_diag = 1.0 - theta * dt * b_coef
    a_u = -theta * dt * c_coef
    col = lambda x: x.reshape(-1)[:, None, None]
    l = torch.where(has_l, col(a_l), 0.0)  # (S*B, m, 2)
    c = torch.where(real, col(a_c_diag), 1.0)
    u = torch.where(has_u, col(a_u), 0.0)
    w, af, ab = _per_row_thomas(l, c, u)
    # spike vectors, both right-hand sides in one solve: vsp_j = a_l A_j^{-1} e_0
    # (coupling to b_{j-1}), wsp_j = a_u A_j^{-1} e_{m-1} (coupling to
    # t_{j+1}); chunk P-1 has no right coupling (chunk 0's missing left one
    # is expand_fields' zero)
    e = torch.zeros_like(c).repeat(1, 1, 2)
    e[:, 0, :2] = 1.0
    e[:, m - 1, 2:] = 1.0
    y = _chunk_solve(*(x.repeat(1, 1, 2) for x in (w, af, ab)), e)
    vsp = col(a_l) * y[..., :2]
    wsp = col(a_u) * y[..., 2:]
    wsp[:, :, 1] = 0.0
    fields = torch.stack([w, af, ab, vsp, wsp], dim=1).transpose(2, 3)  # (S*B, 5, 2, m)
    tips = interface_tips(fields, P)
    iface, det = interface_factors(*tips)
    refusal = interface_refusal(*tips, det)
    if refusal is not None:
        return None, refusal
    coef = torch.stack(
        [
            (1.0 - theta) * dt * a_coef,
            1.0 + (1.0 - theta) * dt * b_coef,
            (1.0 - theta) * dt * c_coef,
            a_l,
            a_u,
            dt,
            # the explicit row sum bl + bc + bu, for the American march's
            # rhs (see spike_march_reference)
            1.0 - (1.0 - theta) * dt * r,
        ],
        dim=2,
    )
    return (coef, fields.view(S, B, 5, 2, m), iface.view(S, B, len(IFACE_ROWS), P)), None


def prepare_spike(
    batch, sigma, n_nodes: int, P: Optional[int], set_defs, american: bool = False,
    strict: bool = True,
) -> Optional[SpikePrep]:
    """Host prep of one SPIKE solve at ``P`` chunks per trade.

    ``set_defs`` is ``((theta, k_col), ...)``: one solver set per entry,
    with dt read from ``batch.dt[:, k_col]``. ``american`` selects the
    Ikonen–Toivanen march (see :class:`SpikePrep`).

    ``P=None`` takes the rule's P (:func:`spike_p_choices`): its first
    choice, and the one-warp P where the interface guard
    (:func:`interface_refusal`) refuses a P of several warps, since shorter
    chunks couple the interface system more. Where the guard refuses an
    explicit P, or the one-warp P, the prep raises ValueError, or returns
    None when not ``strict`` (the verdict of ``solver="auto"``'s route).
    """
    if P is not None:
        return _prepare(batch, sigma, n_nodes, P, set_defs, american, strict)
    choices = spike_p_choices(n_nodes, batch.x_min.shape[0])
    if not choices:
        raise ValueError(f"grid too small for SPIKE partitioning: N={n_nodes}")
    for P in choices:
        prep = _prepare(batch, sigma, n_nodes, P, set_defs, american,
                        strict=strict and P == choices[-1])
        if prep is not None:
            return prep
    return None


def _prepare(batch, sigma, n_nodes, P, set_defs, american, strict) -> Optional[SpikePrep]:
    """:func:`prepare_spike` at ``P``; where the interface guard refuses,
    raise ValueError if ``strict``, else return None.

    The prep runs at float64 whatever the march's dtype (that of
    ``batch.x_min``) and is rounded to it once at the end. At float32 the
    per-chunk Thomas recursion and the interface solve would otherwise
    perturb the discrete operator by many roundings, differently for sigma
    and sigma + dv: on the benchmark trade set (CPU, B=48) the float64 prep
    cut the f32 march's vega error against the f64 route from 4.8e-2 to
    9.9e-3 and its price error from 1.7e-4 to 6.2e-5.
    """
    dtype, device = batch.x_min.dtype, batch.x_min.device
    B, N = batch.x_min.shape[0], n_nodes
    n_int, m, n_pad = spike_shape(N, P)
    f = lambda x: x.to(torch.float64)
    sigma = f(sigma)
    r, b, q = f(batch.r), f(batch.b), f(batch.q)

    i = torch.arange(N, dtype=torch.float64, device=device)
    s = torch.exp(f(batch.x_min)[:, None] + i[None, :] * f(batch.dx)[:, None])
    strike = f(batch.strike)
    payoff = torch.where(
        batch.is_call[:, None],
        torch.clamp(s - strike[:, None], min=0.0),
        torch.clamp(strike[:, None] - s, min=0.0),
    )

    sig2 = sigma * sigma
    mu_x = (b - q) - 0.5 * sig2
    dx = f(batch.dx)
    alpha_c = 0.5 * sig2 / (dx * dx)
    beta_adv = mu_x / (2.0 * dx)
    a_coef = alpha_c - beta_adv
    c_coef = alpha_c + beta_adv
    b_coef = -2.0 * alpha_c - r

    # the two columns' row masks: chunk 0 (as every chunk j < P-1) and
    # chunk P-1; interior row g = j*m + ii
    ii = torch.arange(m, device=device)[:, None]
    g = torch.tensor([0, P - 1], device=device)[None, :] * m + ii  # (m, 2)
    real = g < n_int
    has_l = real & (ii > 0)
    has_u = real & (ii < m - 1) & (g < n_int - 1)

    theta = torch.tensor([th for th, _ in set_defs], dtype=torch.float64, device=device)
    dt = torch.stack([f(batch.dt[:, k_col]) for _, k_col in set_defs])
    sets, refusal = _build_solver_sets(
        theta[:, None], dt, r, a_coef, b_coef, c_coef, has_l, has_u, real, m, P
    )
    if refusal is not None:
        if strict:
            raise ValueError(refusal)
        return None
    coef, fields, iface = sets

    # knock-out rows: s is increasing, so each barrier knocks out a prefix
    # (s <= lower) or a suffix (s >= upper) of the interior rows
    below = batch.has_lower[:, None] & (s <= f(batch.lower)[:, None])
    above = batch.has_upper[:, None] & (s >= f(batch.upper)[:, None])
    ko_lo = f(below[:, 1 : N - 1].sum(dim=1))
    ko_hi = n_int - f(above[:, 1 : N - 1].sum(dim=1))
    trade = torch.stack(
        [
            strike, f(batch.is_call), r, b - q - r, f(batch.rebate),
            f(batch.rebate_at_hit), f(batch.rebate_rate), s[:, 0], s[:, -1],
            f(below[:, 0] | above[:, 0]), f(below[:, -1] | above[:, -1]), ko_lo, ko_hi,
        ],
        dim=1,
    )
    gp = torch.arange(P, device=device)[None, :] * m + ii  # (m, P) rows at r = ii*P + j
    g_flat = torch.clamp(gp, max=n_int - 1).reshape(-1)
    real_flat = (gp < n_int).reshape(-1)
    to_rows = lambda full: torch.where(real_flat, full[:, 1 : N - 1][:, g_flat], 0.0)
    g_last = n_int - 1
    out = lambda x: x.to(dtype).contiguous()
    return SpikePrep(
        trade=out(trade),
        coef=out(coef),
        fields=out(fields),
        iface=out(iface),
        tau=out(batch.tau_next),
        mon=out(batch.monitor),
        v0=out(to_rows(payoff)),
        edge0=out(torch.stack([payoff[:, 0], payoff[:, -1]], dim=1)),
        m=m,
        P=P,
        n_int=n_int,
        il=g_last % m,
        american=american,
    )


def spike_march_reference(prep: SpikePrep, t: int, v, edges, k0: int, k1: int, lam=None):
    """Plain PyTorch version of the kernel: march steps [k0, k1) with solver set t.

    ``v`` (B, n_pad) and ``edges`` (B, 2) are the state entering step k0;
    returns the state after step k1-1, ``(v, edges)``. For an American prep
    ``lam`` (B, n_pad) is the Ikonen–Toivanen multiplier entering step k0
    and the return is ``(v, edges, lam)``. Follows the TPU kernel
    ``_kernel_spike`` band by band, both branches, except the interface
    solve: the banded :func:`interface_solve` in place of JAX's dense
    inverse matvec, and the knock-out rows from two indices per trade.

    One deliberate difference in the American branch: its explicit rhs is
    ``bsum*v + bl*(v_prev - v) + bu*(v_next - v)``, with the row sum
    ``bsum = 1 - (1-theta)*dt*r`` computed at float64, instead of
    ``bc*v + bl*v_prev + bu*v_next``. The two are equal in exact
    arithmetic. At the American grid's dt/dx^2 (bl, bu ~ 47 and bc ~ -93 at
    N=1024, 512 steps, T=1) rounding bc to float32 perturbs the row sum by
    ~5e-6 against the discount term (1-theta)*dt*r ~ 6e-5 it carries, and
    that alone moved float32 values by ~4e-2 on the American bench set
    (``python -m finite_difference_tpu_torch.f32_budget``); the row-sum
    form keeps the discount exact to float32.
    """
    if prep.american != (lam is not None):
        raise ValueError("spike_march: lam is required for an American prep, and only for one")
    B = v.shape[0]
    m, P, il = prep.m, prep.P, prep.il
    (strike, is_call, r, growth_rate, rebate, at_hit, rebate_rate,
     s_min, s_max, omask_lo, omask_hi) = prep.trade.unbind(1)[:11]
    is_call, at_hit = is_call != 0, at_hit != 0
    omask_lo, omask_hi = omask_lo != 0, omask_hi != 0
    bl, bc, bu, al, au, dt, bsum = (x[:, None] for x in prep.coef[t].unbind(1))
    w, af, ab, vsp, wsp = expand_fields(prep.fields[t], P)
    iface = prep.iface[t]
    out_mask = ko_rows(prep)
    zero = torch.zeros_like(strike)
    if prep.american:
        payoff = prep.v0.view(B, m, P)
        lam = lam.view(B, m, P)

    v = v.view(B, m, P).clone()
    v_lo, v_hi = edges[:, 0], edges[:, 1]
    for k in range(k0, k1):
        tau = prep.tau[:, k]
        growth = torch.exp(growth_rate * tau)
        disc = torch.exp(-r * tau)
        # American pricer convention (fd_american_equity.py:474-478): the
        # put's lower edge is K e^{-r tau}, without the S_min asymptote
        v_min_put = strike * disc if prep.american else strike * disc - s_min * growth
        v_min_n = torch.where(is_call, zero, v_min_put)
        v_max_n = torch.where(is_call, s_max * growth - strike * disc, zero)

        # band-streamed rhs + forward chain; cross-chunk neighbours only at
        # the first and last band
        first, last = v[:, 0], v[:, m - 1]
        v_prev = torch.cat([v_lo[:, None], last[:, :-1]], dim=1)
        up_fix = torch.roll(first, -1, dims=1)
        v_cur = first
        dp = torch.empty_like(v)
        for ii in range(m):
            v_next = v[:, ii + 1] if ii < m - 1 else up_fix
            if prep.american:
                if ii == il:  # global-last row: its upper neighbour is the edge
                    v_next = v_next.clone()
                    v_next[:, P - 1] = v_hi
                # row-sum form of bc*v + bl*v_prev + bu*v_next (see below),
                # plus the Ikonen–Toivanen source term (0 on pads)
                rhs = bsum * v_cur + bl * (v_prev - v_cur) + bu * (v_next - v_cur)
                rhs = rhs + dt * lam[:, ii]
            else:
                rhs = bc * v_cur + bl * v_prev + bu * v_next
            if ii == 0:  # global row 0: implicit lower-boundary coupling
                rhs[:, 0] = rhs[:, 0] - al[:, 0] * v_min_n
            if ii == il and prep.american:
                rhs[:, P - 1] = rhs[:, P - 1] - au[:, 0] * v_max_n
            elif ii == il:  # global-last row: its upper neighbour was a zero pad
                rhs[:, P - 1] = rhs[:, P - 1] + (bu[:, 0] * v_hi - au[:, 0] * v_max_n)
            elif ii > il:  # pad rows
                rhs[:, P - 1] = 0.0
            d = w[:, 0] * rhs if ii == 0 else w[:, ii] * rhs + af[:, ii] * d
            dp[:, ii] = d
            v_prev, v_cur = v_cur, v_next
        y_bot = d
        x = d
        for ii in range(m - 2, -1, -1):
            x = dp[:, ii] + ab[:, ii] * x
            dp[:, ii] = x
        y_top = x

        bprev, tnext = interface_solve(iface, y_top, y_bot)  # b_{j-1}, t_{j+1}

        # spike correction + KO projection
        mon = prep.mon[:, k] != 0
        rebate_pv = torch.where(at_hit, rebate, rebate * torch.exp(-rebate_rate * tau))
        xr = dp - bprev[:, None, :] * vsp - tnext[:, None, :] * wsp
        if prep.american:
            # v = max(payoff, tilde - dt*lam_old);
            # lam_new = max(0, lam_old + (payoff - tilde)/dt)
            dt3 = dt[:, :, None]
            v_am = torch.maximum(payoff, xr - dt3 * lam)
            lam = torch.clamp(lam + (payoff - xr) / dt3, min=0.0)
            xr = v_am
        v = torch.where(mon[:, None, None] & out_mask, rebate_pv[:, None, None], xr)
        v_lo = torch.where(mon & omask_lo, rebate_pv, v_min_n)
        v_hi = torch.where(mon & omask_hi, rebate_pv, v_max_n)
    out = (v.reshape(B, m * P), torch.stack([v_lo, v_hi], dim=1))
    return (*out, lam.reshape(B, m * P)) if prep.american else out


def spike_march(prep: SpikePrep, t: int, v, edges, k0: int, k1: int, lam=None):
    """One segment of the march, with :func:`spike_march_reference`'s
    arguments and returns: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. There is no fallback between the two: a kernel
    that fails to build or launch raises."""
    if v.device.type == "cuda":
        if prep.american:
            return kernels.spike_march_american_cuda(prep, t, v, edges, lam, k0, k1)
        return kernels.spike_march_cuda(prep, t, v, edges, k0, k1)
    if v.device.type == "cpu":
        return spike_march_reference(prep, t, v, edges, k0, k1, lam)
    raise ValueError(f"spike_march: unsupported device {v.device}")


def require_default_schedule(batch, n_steps: int, rannacher_steps: int, what: str, hint: str = "") -> None:
    """Raise ValueError unless the first ``n_steps`` steps of ``batch`` have
    a uniform dt per trade, theta = 1 on the first ``rannacher_steps`` of
    them and 1/2 after, and no dividends: the schedule family that one
    (theta, dt) pair per Rannacher phase describes. Applied to another
    schedule, such a march would silently price with ``dt[:, 0]``
    everywhere."""
    n_rann = min(rannacher_steps, n_steps)
    dt = batch.dt[:, :n_steps]
    expect = torch.where(torch.arange(n_steps, device=dt.device) < n_rann, 1.0, 0.5)
    if not (
        bool((dt == dt[:, :1]).all())
        and bool((batch.theta[:, :n_steps] == expect.to(batch.theta.dtype)).all())
        and not bool((batch.div_amount != 0).any())
    ):
        raise ValueError(
            f"{what} assumes globally-uniform dt with a {n_rann}-step "
            f"Rannacher prefix and no dividends{hint}"
        )


def default_segments(n_steps: int, rannacher_steps: int = 2):
    """(segments, set_defs) of a globally uniform dt with a Rannacher prefix."""
    n_rann = min(rannacher_steps, n_steps)
    set_defs, segments = [], []
    if n_rann > 0:
        set_defs.append((1.0, 0))
        segments.append((0, n_rann, 0))
    if n_steps > n_rann:
        set_defs.append((0.5, 0))
        segments.append((n_rann, n_steps, len(set_defs) - 1))
    return tuple(segments), tuple(set_defs)


def assemble(prep: SpikePrep, v, edges):
    """The (B, N) value grids of a march state (the untranspose): position
    r = ii*P + j holds interior row g = j*m + ii."""
    B = v.shape[0]
    interior = v.view(B, prep.m, prep.P).transpose(1, 2).reshape(B, -1)[:, : prep.n_int]
    return torch.cat([edges[:, :1], interior, edges[:, 1:]], dim=1)


def _to_rows(prep: SpikePrep, v_full):
    """Inverse of :func:`assemble`: (v (B, n_pad) with pads at 0, edges (B, 2))."""
    B = v_full.shape[0]
    pad = v_full.new_zeros(B, prep.m * prep.P - prep.n_int)
    rows = torch.cat([v_full[:, 1:-1], pad], dim=1).view(B, prep.P, prep.m)
    return rows.transpose(1, 2).reshape(B, -1), torch.stack([v_full[:, 0], v_full[:, -1]], dim=1)


def _dividend_jump(batch, prep: SpikePrep, v, edges, k: int):
    """The cash-dividend jump after step k, between two launches
    (pallas_kernel.py:1090-1115): V(t-, S) = V(t+, S - D) through the
    batched natural cubic spline, the interval bracket in closed form on
    the log-uniform grid, and the American call's exercise check at ex-div.
    Trades with no dividend at k keep their values.

    It runs at float64 and is rounded once to the march's dtype, as the
    prep is: at float64 this is the JAX package's arithmetic; at float32
    it is a deliberate difference from JAX's f32 jump.
    """
    f = lambda x: x.to(torch.float64)
    v_full = f(assemble(prep, v, edges))
    i = torch.arange(v_full.shape[1], dtype=torch.float64, device=v.device)
    x_min, dx = f(batch.x_min)[:, None], f(batch.dx)[:, None]
    s = torch.exp(x_min + i[None, :] * dx)
    d = f(batch.div_amount[:, k])[:, None]
    xq = s - d
    j_idx = torch.floor((torch.log(torch.maximum(xq, s[:, :1])) - x_min) / dx).long()
    v_shift = cubic_spline_eval(natural_cubic_spline(s, v_full), xq, j_idx)
    # American calls may exercise just before ex-div
    payoff = _payoff(s, f(batch.strike), batch.is_call)
    v_shift = torch.where(batch.is_call[:, None], torch.maximum(v_shift, payoff), v_shift)
    v_full = torch.where(d != 0.0, v_shift, v_full)
    return _to_rows(prep, v_full.to(v.dtype))


def march_segments(batch, prep: SpikePrep, segments, div_steps=(), reset_steps=(), step=spike_march):
    """Run ``segments`` ``((k0, k1, set_idx), ...)`` from the prep's payoff:
    the final march state ``(v, edges)``.

    For an American prep, lambda starts at 0, is zeroed per trade (from
    ``batch.reset_lambda``) at each segment start listed in
    ``reset_steps``, and each segment ending at a step listed in
    ``div_steps`` is followed by the dividend jump (from
    ``batch.div_amount``). ``step`` is the segment march, with
    :func:`spike_march_reference`'s signature: :func:`spike_march` by
    default; a caller may pass the plain version or the kernel to compare
    the two on the same device.
    """
    v, edges = prep.v0, prep.edge0
    lam = torch.zeros_like(v) if prep.american else None
    div_set, reset_set = frozenset(div_steps), frozenset(reset_steps)
    for k0, k1, t in segments:
        if not prep.american:
            v, edges = step(prep, t, v, edges, k0, k1)
            continue
        if k0 in reset_set:
            lam = lam * (1.0 - batch.reset_lambda[:, k0].to(lam.dtype))[:, None]
        v, edges, lam = step(prep, t, v, edges, k0, k1, lam)
        if k1 - 1 in div_set:
            v, edges = _dividend_jump(batch, prep, v, edges, k1 - 1)
    return v, edges


def cn_barrier_solve_spike(
    batch,
    sigma,
    n_nodes: int,
    n_steps: int,
    rannacher_steps: int = 2,
    p_chunks: Optional[int] = None,
    segments: Optional[Sequence[Tuple[int, int, int]]] = None,
    set_defs: Optional[Sequence[Tuple[float, int]]] = None,
    american: bool = False,
    div_steps: Sequence[int] = (),
    reset_steps: Sequence[int] = (),
    prep: Optional[SpikePrep] = None,
):
    """SPIKE-partitioned CN solve of a barrier or American batch: the values V (B, N).

    One march launch per run of steps sharing a (theta, dt) pair:

    - default (``segments=None``): globally uniform dt with the
      ``rannacher_steps``-step theta=1 prefix — two segments;
    - ``segments``/``set_defs`` (host-derived, see
      ``batch._spike_schedule_impl``): ``set_defs`` is ``((theta, k_col), ...)``,
      ``segments`` is ``((k0, k1, set_idx), ...)`` covering [0, n_steps),
      which admits monitor-aligned per-interval dt layouts and the American
      dividend segments.

    ``american=True`` runs the Ikonen–Toivanen branch; ``div_steps`` and
    ``reset_steps`` (American only, from ``batch._spike_schedule_impl``)
    place the dividend jumps and lambda resets between launches (see
    :func:`march_segments`). ``p_chunks=None`` takes the rule's P (see
    :func:`prepare_spike`). ``prep``, where given, is that prep made
    beforehand for this ``batch``, ``sigma`` and ``set_defs`` (as
    ``solver="auto"``'s route does, to read the interface guard's verdict
    from it) and is marched as given, ``p_chunks`` unread. The
    march runs on the device of ``batch``: the CUDA kernel on a card, its
    plain version on the CPU.
    """
    if segments is None or set_defs is None:
        require_default_schedule(
            batch, n_steps, rannacher_steps, "segments=None",
            hint="; pass the host-derived (segments, set_defs) from "
            "models.pde.batch._spike_schedule_impl for piecewise-constant schedules",
        )
        segments, set_defs = default_segments(n_steps, rannacher_steps)
    if segments[0][0] != 0 or segments[-1][1] != n_steps or any(
        s1[1] != s2[0] for s1, s2 in zip(segments[:-1], segments[1:])
    ):
        raise ValueError(f"segments must tile [0, {n_steps}): {segments}")
    if not american and (div_steps or reset_steps):
        raise ValueError("div_steps and reset_steps apply to American batches only")

    if prep is None:
        prep = prepare_spike(batch, sigma, n_nodes, p_chunks, set_defs, american=american)
    v, edges = march_segments(batch, prep, segments, div_steps, reset_steps)
    return assemble(prep, v, edges)

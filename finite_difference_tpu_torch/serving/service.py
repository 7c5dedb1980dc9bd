"""Shape-bucketed pricing services on the port's batch drivers.

Counterpart of ``finite_difference_tpu.serving.service``. Each service fixes
the grid and schedule shapes at construction and rounds every request up to
a power-of-two bucket, padding with clones of the first trade (the padded
rows are dropped from the results), so a handful of batch shapes serve every
request size: on a card, the SPIKE kernels' launch shapes and the spectral
route's CUDA graphs (``spectral.run_graphed``, whose key is also the trades'
monitor layout) are per bucket.

Knock-in trades are served via the in-out parity (KI(R) = vanilla −
KO(R at expiry) + R·DF), with the vanilla leg's greeks from closed-form
bumps of the generalized Black–Scholes price, applied on the device to the
stack of the request's outputs before its one host copy: on a card by one
launch of ``csrc/ki_parity.cu``, elsewhere by :func:`ki_parity_reference`.

A service serialises its device work: ``price`` may be called from several
threads, and one request at a time builds its batch and prices it. A
service built with ``mesh`` (a ``parallel.Mesh``) splits each bucket's
trades over the mesh's ``"data"`` axis (the drivers' ``mesh=``); the
mesh may also be named as data, as a configuration file holds it: a device
count or a list of device names (``parallel.mesh.check_mesh``).
"""
from __future__ import annotations

import operator
import threading
import weakref
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels, tracing
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.analytic import (
    continuous_barrier_sweep,
    continuous_barrier_sweep_greeks,
    generalized_bs_price,
    monitoring_decision,
)
from ..models.pde.batch import (
    BarrierTradeBatch,
    build_american_batch,
    build_trade_batch,
    pad_batch,
    price_american_batch,
    price_barrier_batch,
)
from ..parallel.mesh import check_mesh

__all__ = ["BarrierPricingService", "AmericanPricingService"]

_GREEK_KEYS = kernels.KI_OUTPUTS  # the outputs, in the order of a request's stack
_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _torch_dtype(dtype) -> torch.dtype:
    """float32 or float64, given as a torch dtype or anything numpy reads."""
    if isinstance(dtype, torch.dtype):
        if dtype in _DTYPES.values():
            return dtype
    elif np.dtype(dtype) in _DTYPES:
        return _DTYPES[np.dtype(dtype)]
    raise ValueError(f"dtype must be float32 or float64, got {dtype!r}")


def _resolve_greeks_dtype(dtype, with_greeks: bool, greeks_dtype) -> torch.dtype:
    """The f32-greeks policy: a service asked for greeks solves at float64
    unless ``greeks_dtype`` says otherwise; a price-only service keeps
    ``dtype``.

    The evidence (chip_smoke.py's serving phase on an NVIDIA H100 80GB HBM3
    at 700 W, 512 mixed trades at 512 steps x 1024 nodes): float32 services'
    bump greeks differ from the float64 services' by 1.0e-3 (gamma), 1.3e-3
    (theta) and 2.7e-2 (vega) of their max on barriers, 2.4e-2 (gamma) and
    5.2e-2 (vega) on Americans: at or above the 1e-3 or better of the
    production greek differences the JAX package's policy cites. A float64
    solve prices from the same grid, so its price is the more accurate too.
    Pass ``greeks_dtype=float32`` to opt into float32 bump greeks.
    """
    if not with_greeks or greeks_dtype is not None:
        return _torch_dtype(greeks_dtype if greeks_dtype is not None else dtype)
    dt = _torch_dtype(dtype)
    return torch.float64 if dt == torch.float32 else dt


def _next_bucket(n: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest power-of-two >= n, clamped to [min_bucket, max_bucket]."""
    if n > max_bucket:
        raise ValueError(
            f"request of {n} trades exceeds max_bucket={max_bucket}; "
            "split the request or raise max_bucket"
        )
    b = max(min_bucket, 1)
    while b < n:
        b <<= 1
    return min(b, max_bucket)


def _stack(out: Dict[str, torch.Tensor], n: int) -> Tuple[List[str], torch.Tensor]:
    """The outputs' keys, and the first ``n`` rows of each output as one
    (K, n) float64 stack on their device."""
    keys = [k for k in _GREEK_KEYS if k in out]
    return keys, torch.stack([out[k][:n].to(torch.float64) for k in keys])


def _host(keys: List[str], stack: torch.Tensor) -> Dict[str, np.ndarray]:
    """The stack on the host, a column per key, in one copy (the host waits
    here for the device's work)."""
    return dict(zip(keys, stack.cpu().numpy()))


def _columns(out: Dict[str, torch.Tensor], n: int) -> Dict[str, np.ndarray]:
    """The first ``n`` rows of each output, float64 on the host, in one copy."""
    with tracing.span("service.host_copy"):
        return _host(*_stack(out, n))


def _rows(cols: Dict[str, np.ndarray], n: int) -> List[Dict[str, float]]:
    return [{k: float(v[i]) for k, v in cols.items()} for i in range(n)]


# the vanilla-leg fields of a knock-in trade, the rows of KnockIns.fields,
# by the names of build_batch's field lists (carry is b - q; is_call 1 or 0)
KI_FIELDS = ("spots", "strikes", "sigmas", "t_expiry", "r", "carry", "is_call", "rebate")


class KnockIns(NamedTuple):
    """A request's knock-in trades on the service's device."""

    rows: torch.Tensor  # (n,) int64: each one's row in the request
    fields: torch.Tensor  # (8, n) float64: KI_FIELDS


def _knock_ins(fields: Dict[str, list], is_in: Sequence[bool], device) -> Optional[KnockIns]:
    """The knock-in trades of a request, gathered from ``build_batch``'s
    field lists at float64 (the trades' own values, whatever the service's
    dtype) and sent to ``device`` in two copies; None when none knocks in."""
    rows = [i for i, ki in enumerate(is_in) if ki]
    if not rows:
        return None
    pick = operator.itemgetter(*rows) if len(rows) > 1 else (lambda v: (v[rows[0]],))
    # the closed forms fold the escrowed dividend into the carry
    carry = np.subtract(pick(fields["b"]), pick(fields["q"]))
    cols = np.array([carry if k == "carry" else pick(fields[k]) for k in KI_FIELDS], np.float64)
    return KnockIns(torch.as_tensor(np.asarray(rows, np.int64)).to(device),
                    torch.from_numpy(cols).to(device))


def ki_parity_reference(stack: torch.Tensor, keys: Sequence[str], rows: torch.Tensor,
                        fields: torch.Tensor) -> None:
    """KI(R) = vanilla − KO(R at expiry) + R·DF, greeks likewise, in place
    on the (K, B) float64 ``stack`` of a request's outputs (row i output
    ``keys[i]``): its columns ``rows`` hold the knock-out legs and receive
    the knock-in trades', from their ``fields`` ((8, n) float64,
    :data:`KI_FIELDS`). The plain version of ``csrc/ki_parity.cu``, on any
    device.

    The vanilla leg is one ``generalized_bs_price`` over the stacked
    evaluations the present outputs need: the base price, spot ± 1e-4·spot
    (delta, gamma), sigma + 1e-4 (vega per vol point, one-sided like the
    scalar engine's _vanilla_black76_greeks_fd), expiry ± min(1e-5,
    expiry/2) (theta). The rebate leg R·DF is flat in spot and vol, so only
    price and theta see it. Every divisor is a tensor: a card divides by a
    number as the product with its reciprocal.
    """
    at = {k: i for i, k in enumerate(keys)}
    s, k, sig, te, r, carry, call, rebate = fields.unbind(0)
    ds = s * 1e-4
    dsig = torch.full_like(sig, 1e-4)
    dte = torch.clamp(0.5 * te, max=1e-5)
    spot_bump = "delta" in at or "gamma" in at
    bumps = [(s, sig, te)]
    if spot_bump:
        bumps += [(s + ds, sig, te), (s - ds, sig, te)]
    if "vega" in at:
        bumps.append((s, sig + dsig, te))
    if "theta" in at:
        bumps += [(s, sig, te + dte), (s, sig, te - dte)]
    spot, vol, expiry = (torch.stack(c) for c in zip(*bumps))
    van, *bumped = generalized_bs_price(spot, k, vol, expiry, r, carry, call != 0.0).unbind(0)
    df = torch.exp(-r * te)
    ko = stack.index_select(1, rows)
    ki = ko.clone()
    ki[at["price"]] = van - ko[at["price"]] + rebate * df
    if spot_bump:
        up, dn, *bumped = bumped
        if "delta" in at:
            ki[at["delta"]] = (up - dn) / (2.0 * ds) - ko[at["delta"]]
        if "gamma" in at:
            ki[at["gamma"]] = (up - 2.0 * van + dn) / (ds * ds) - ko[at["gamma"]]
    if "vega" in at:
        v_vol, *bumped = bumped
        ki[at["vega"]] = (v_vol - van) / (100.0 * dsig) - ko[at["vega"]]
    if "theta" in at:
        # theta = dV/dt (valuation time) = -dV/dT; d(R·DF)/dt = r·R·DF
        later, sooner = bumped
        ki[at["theta"]] = -(later - sooner) / (2.0 * dte) - ko[at["theta"]] + r * rebate * df
    stack.index_copy_(1, rows, ki)


class _BucketedService:
    """Shared bucketing, locking and stats; subclasses build and price batches."""

    def __init__(self, min_bucket: int, max_bucket: int, mesh, device) -> None:
        if min_bucket < 1 or max_bucket < min_bucket:
            raise ValueError("need 1 <= min_bucket <= max_bucket")
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self.device = resolve_device(device)
        self.mesh = check_mesh(mesh, self.device)
        self._lock = threading.Lock()  # one request at a time: its stats and device work
        self.stats: Dict[str, Any] = {
            "requests": 0,
            "trades": 0,
            "bucket_hits": {},
        }

    def price(self, trades: Sequence[Mapping[str, Any]]) -> List[Dict[str, float]]:
        """Rows of price and greeks, one per trade, in order; one request
        (the root span ``service.price`` while a profiler collects)."""
        if not trades:
            return []
        bucket = _next_bucket(len(trades), self.min_bucket, self.max_bucket)
        with tracing.span("service.price", trades=len(trades), bucket=bucket), self._lock:
            self.stats["requests"] += 1
            self.stats["trades"] += len(trades)
            hits = self.stats["bucket_hits"]
            hits[bucket] = hits.get(bucket, 0) + 1
            return self._price_bucketed(list(trades), bucket)

    def _price_bucketed(self, trades, bucket):  # pragma: no cover - abstract
        raise NotImplementedError


class BarrierPricingService(_BucketedService):
    """Discretely-monitored barrier (and vanilla) pricing service.

    Trade dicts (floats resolved — dates and calendars are the caller's):

    - ``spot``, ``strike``, ``sigma``, ``t_expiry``, ``r`` (NACC);
      optional ``b`` (carry, default r), ``q`` (escrowed dividend NACC,
      default 0), ``is_call`` (default True);
    - ``monitor_times``: year fractions of the monitor dates (a final
      monitor at expiry is appended when missing); default: expiry only;
    - ``barrier_type``: 'none' | 'up-and-out' | 'down-and-out' |
      'double-out' | 'up-and-in' | 'down-and-in' | 'double-in'
      with ``upper``/``lower`` levels as applicable;
    - ``rebate`` (default 0), ``rebate_at_hit`` (default False).

    The grid (``n_time_steps`` x ``num_space_nodes``), the dtype and the
    device are fixed per service. ``dtype`` and ``greeks_dtype`` take torch
    or numpy dtypes; a greek-bearing float32 service solves at float64
    unless ``greeks_dtype=float32`` (:func:`_resolve_greeks_dtype`).
    ``solver``, ``greeks_mode`` and ``max_chunk`` go to
    ``price_barrier_batch``; so does ``mesh``, split over its ``"data"``
    axis: None, a ``parallel.Mesh``, an int n (the first n CUDA devices,
    ``parallel.make_mesh(n)``) or a list of device names
    (``make_mesh(devices=...)``, e.g. ``["cuda:0", "cuda:1"]`` or
    ``["cpu"] * 4``), of ``device``'s type (ValueError otherwise). The int
    and the list are the port's own: the JAX service takes a
    ``jax.sharding.Mesh`` only.

    ``route='hybrid'`` applies the FIS n_lim monitoring decision per trade
    (reference semantics discrete_barrier_analytic_pricer.py:278-342):
    continuous-regime trades — more monitors than the PDE time grid can
    resolve — are priced by the batched analytic sweep with BGK-shifted
    barriers instead of the CN batch. Rebate-bearing trades always stay on
    the PDE lane (the analytic sweep's rebate legs don't cover doubles).
    """

    def __init__(
        self,
        n_time_steps: int = 512,
        num_space_nodes: int = 1023,
        *,
        with_greeks: bool = True,
        greeks_mode: str = "bump",
        solver: str = "auto",
        dtype=np.float64,
        max_chunk: Optional[int] = 1024,
        min_bucket: int = 8,
        max_bucket: int = 4096,
        mesh=None,
        route: str = "pde",
        greeks_dtype=None,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(min_bucket, max_bucket, mesh, device)
        if route not in ("pde", "hybrid"):
            raise ValueError(f"route must be 'pde' or 'hybrid', got {route!r}")
        self.n_time_steps = int(n_time_steps)
        self.num_space_nodes = int(num_space_nodes)
        self.with_greeks = bool(with_greeks)
        self.greeks_mode = greeks_mode
        self.solver = solver
        self.dtype = _resolve_greeks_dtype(dtype, self.with_greeks, greeks_dtype)
        self.max_chunk = max_chunk
        self.route = route
        # each thread's last build_batch: (a weak reference to the batch,
        # its KnockIns or None)
        self._built = threading.local()

    @staticmethod
    def _barriers(trade: Mapping[str, Any]):
        bt = str(trade.get("barrier_type", "none"))
        upper = trade.get("upper")
        lower = trade.get("lower")
        is_in = "in" in bt
        if bt == "none":
            upper = lower = None
        elif "up" in bt:
            if upper is None:
                raise ValueError(f"{bt} requires 'upper'")
            lower = None
        elif "down" in bt:
            if lower is None:
                raise ValueError(f"{bt} requires 'lower'")
            upper = None
        elif "double" in bt:
            if upper is None or lower is None:
                raise ValueError(f"{bt} requires 'upper' and 'lower'")
        else:
            raise ValueError(f"unknown barrier_type {bt!r}")
        return lower, upper, is_in

    @staticmethod
    def _monitors(trades) -> List[List[float]]:
        out = []
        for t in trades:
            te = float(t["t_expiry"])
            m = [float(x) for x in t.get("monitor_times", [te])]
            # the engines always monitor at expiry (barrier.py convention)
            if not m or m[-1] < te - 1e-14:
                m.append(te)
            out.append(m)
        return out

    def _price_bucketed(self, trades, bucket):
        if self.route == "hybrid":
            return self._price_hybrid(trades)
        return self._price_pde(trades, bucket)

    def _price_hybrid(self, trades):
        """Split the request by the FIS n_lim rule; price each lane once."""
        use_cont, adj = monitoring_decision(
            np.array([float(t["t_expiry"]) for t in trades]),
            self._monitors(trades),
            np.array([float(t["sigma"]) for t in trades]),
        )
        use_cont &= np.array([float(t.get("rebate", 0.0)) == 0.0 for t in trades])
        pde_i = [i for i in range(len(trades)) if not use_cont[i]]
        cont_i = [i for i in range(len(trades)) if use_cont[i]]
        results: List[Optional[Dict[str, float]]] = [None] * len(trades)
        if pde_i:
            bucket = _next_bucket(len(pde_i), self.min_bucket, self.max_bucket)
            for i, row in zip(pde_i, self._price_pde([trades[i] for i in pde_i], bucket)):
                results[i] = row
        if cont_i:
            for i, row in zip(cont_i, self._price_continuous([trades[i] for i in cont_i],
                                                             adj[cont_i])):
                results[i] = row
        return results

    def _price_continuous(self, trades, bgk_adj):
        """Analytic lane: continuous sweep with BGK-shifted barriers, on the
        service's device."""
        lowers, uppers, is_in = [], [], []
        for t, a in zip(trades, bgk_adj):
            lo, up, ki = self._barriers(t)
            lowers.append(None if lo is None else float(lo) / a)
            uppers.append(None if up is None else float(up) * a)
            is_in.append(ki)
        col = lambda f: np.array([f(t) for t in trades], np.float64)
        s = col(lambda t: t["spot"])
        k = col(lambda t: t["strike"])
        sig = col(lambda t: t["sigma"])
        te = col(lambda t: t["t_expiry"])
        r = col(lambda t: t["r"])
        # the PDE lane's dynamics use carry b with escrowed-dividend NACC q
        # subtracted from the drift; the closed forms fold that into b
        b = col(lambda t: t.get("b", t["r"])) - col(lambda t: t.get("q", 0.0))
        is_call = np.array([bool(t.get("is_call", True)) for t in trades])
        kw = dict(lower=lowers, upper=uppers, is_call=is_call, is_in=np.asarray(is_in),
                  device=self.device)
        px = lambda te_: continuous_barrier_sweep(s, k, te_, r, b, sig, **kw).cpu().numpy()
        if not self.with_greeks:
            return _rows({"price": px(te)}, len(trades))
        cols = _columns(continuous_barrier_sweep_greeks(
            s, k, te, r, b, sig, greeks_mode=self.greeks_mode, **kw), len(trades))
        # theta by central maturity bump (the KI-parity leg's convention)
        dte = np.minimum(1e-5, 0.5 * te)
        cols["theta"] = -(px(te + dte) - px(te - dte)) / (2.0 * dte)
        return _rows(cols, len(trades))

    def build_batch(self, trades, bucket: int) -> BarrierTradeBatch:
        """The device batch a request of ``trades`` is priced on: built at
        the service's grid and dtype, padded to ``bucket`` trades. Knock-in
        trades appear as their knock-out complement (rebate at expiry);
        their vanilla legs' fields go to the device beside the batch, from
        the same pass over the trade dicts (:meth:`_knock_ins_of`)."""
        with tracing.span("service.build_batch"):
            with tracing.span("service.trade_fields"):
                lowers, uppers, is_in = zip(*(self._barriers(t) for t in trades))
                fields = dict(
                    spots=[float(t["spot"]) for t in trades],
                    strikes=[float(t["strike"]) for t in trades],
                    sigmas=[float(t["sigma"]) for t in trades],
                    t_expiry=[float(t["t_expiry"]) for t in trades],
                    r=[float(t["r"]) for t in trades],
                    b=[float(t.get("b", t["r"])) for t in trades],
                    is_call=[bool(t.get("is_call", True)) for t in trades],
                    monitor_times=self._monitors(trades),
                    lower=list(lowers),
                    upper=list(uppers),
                    q=[float(t.get("q", 0.0)) for t in trades],
                    rebate=[float(t.get("rebate", 0.0)) for t in trades],
                    # the IN parity complement carries its rebate at EXPIRY
                    # (KI(R) = vanilla - KO(R at expiry) + R*DF)
                    rebate_at_hit=[
                        bool(t.get("rebate_at_hit", False)) and not ki for t, ki in zip(trades, is_in)
                    ],
                )
            tb = build_trade_batch(
                **fields,
                n_time_steps=self.n_time_steps,
                num_space_nodes=self.num_space_nodes,
                dtype=self.dtype,
                device=self.device,
            )
            batch = pad_batch(tb, bucket - len(trades))
            self._built.last = (weakref.ref(batch), _knock_ins(fields, is_in, self.device))
            return batch

    def _knock_ins_of(self, batch: BarrierTradeBatch) -> Optional[KnockIns]:
        """The knock-in trades of ``batch``, which must be what this
        thread's last :meth:`build_batch` returned: another thread's build
        cannot hand its knock-ins to this thread's request."""
        built, knock_ins = getattr(self._built, "last", (lambda: None, None))
        if built() is not batch:
            raise RuntimeError("the batch is not the one this thread's last build_batch returned")
        return knock_ins

    def _price_pde(self, trades, bucket):
        B = len(trades)
        batch = self.build_batch(trades, bucket)
        knock_ins = self._knock_ins_of(batch)
        del self._built.last
        out = price_barrier_batch(
            batch,
            n_nodes=self.num_space_nodes + 1,
            with_greeks=self.with_greeks,
            max_chunk=self.max_chunk,
            greeks_mode=self.greeks_mode,
            solver=self.solver,
            device=self.device,
            mesh=self.mesh,
        )
        keys, stack = _stack(out, B)
        if knock_ins is not None:
            self._apply_ki_parity(stack, keys, knock_ins)
        with tracing.span("service.host_copy"):
            cols = _host(keys, stack)
        return _rows(cols, B)

    def _apply_ki_parity(self, stack: torch.Tensor, keys: List[str], knock_ins: KnockIns) -> None:
        """The request's knock-in parity on its (K, B) float64 ``stack`` of
        outputs, on the stack's device: one launch of ``csrc/ki_parity.cu``
        on a card (:func:`kernels.ki_parity_cuda`), else
        :func:`ki_parity_reference`. Nothing crosses to the host here."""
        with tracing.span("service.ki_parity", trades=knock_ins.rows.shape[0]):
            parity = kernels.ki_parity_cuda if stack.is_cuda else ki_parity_reference
            parity(stack, keys, *knock_ins)


class AmericanPricingService(_BucketedService):
    """American option pricing service on the batched CN sweep (the SPIKE
    march on a card, under ``solver="auto"``).

    Trade dicts: ``spot``, ``strike``, ``sigma``, ``t_expiry``, ``r``;
    optional ``b`` (default r), ``is_call`` (default False — puts are the
    production American workload), ``dividends``: list of
    ``[tau_from_expiry, amount]`` pairs (``build_american_batch``'s layout).

    ``richardson=True`` serves the reference's production convention
    (AmericanFDMPricer.price_log2/greeks_log2, fd_american_equity.py:925):
    each bucket solves at ``n_time_steps`` and twice that, combined as
    (4*P_fine - P_coarse)/3. ``dtype``, ``greeks_dtype`` and ``device`` as
    for :class:`BarrierPricingService`; so is ``mesh``: None, a
    ``parallel.Mesh``, an int n (the first n CUDA devices) or a list of
    device names, split over its ``"data"`` axis.
    """

    def __init__(
        self,
        n_time_steps: int = 512,
        num_space_nodes: int = 1022,
        *,
        with_greeks: bool = True,
        greeks_mode: str = "bump",
        solver: str = "auto",
        dtype=np.float64,
        max_chunk: Optional[int] = 1024,
        min_bucket: int = 8,
        max_bucket: int = 4096,
        snap_to_grid: bool = False,
        mesh=None,
        richardson: bool = False,
        greeks_dtype=None,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(min_bucket, max_bucket, mesh, device)
        self.n_time_steps = int(n_time_steps)
        self.num_space_nodes = int(num_space_nodes)
        self.with_greeks = bool(with_greeks)
        self.greeks_mode = greeks_mode
        self.solver = solver
        self.dtype = _resolve_greeks_dtype(dtype, self.with_greeks, greeks_dtype)
        self.max_chunk = max_chunk
        self.snap_to_grid = bool(snap_to_grid)
        self.richardson = bool(richardson)

    def build_batch(self, trades, bucket: int, n_time_steps: Optional[int] = None):
        """The device batch a request of ``trades`` is priced on, padded to
        ``bucket`` trades (``n_time_steps`` defaults to the service's)."""
        with tracing.span("service.build_batch"):
            with tracing.span("service.trade_fields"):
                fields = dict(
                    spots=[float(t["spot"]) for t in trades],
                    strikes=[float(t["strike"]) for t in trades],
                    sigmas=[float(t["sigma"]) for t in trades],
                    t_expiry=[float(t["t_expiry"]) for t in trades],
                    r=[float(t["r"]) for t in trades],
                    b=[float(t.get("b", t["r"])) for t in trades],
                    is_call=[bool(t.get("is_call", False)) for t in trades],
                    dividends_tau=[
                        [(float(tau), float(amt)) for tau, amt in t.get("dividends", [])]
                        for t in trades
                    ],
                )
            tb = build_american_batch(
                **fields,
                n_time_steps=n_time_steps or self.n_time_steps,
                num_space_nodes=self.num_space_nodes,
                dtype=self.dtype,
                snap_to_grid=self.snap_to_grid,
                device=self.device,
            )
            return pad_batch(tb, bucket - len(trades))

    def _solve(self, trades, bucket, n_time_steps):
        out = price_american_batch(
            self.build_batch(trades, bucket, n_time_steps),
            n_nodes=self.num_space_nodes + 2,
            with_greeks=self.with_greeks,
            max_chunk=self.max_chunk,
            greeks_mode=self.greeks_mode,
            solver=self.solver,
            device=self.device,
            mesh=self.mesh,
        )
        return _columns(out, len(trades))

    def _price_bucketed(self, trades, bucket):
        cols = self._solve(trades, bucket, self.n_time_steps)
        if self.richardson:
            fine = self._solve(trades, bucket, 2 * self.n_time_steps)
            cols = {k: (4.0 * fine[k] - cols[k]) / 3.0 for k in cols}
        return _rows(cols, len(trades))

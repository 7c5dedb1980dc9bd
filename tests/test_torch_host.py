"""Port (finite_difference_tpu_torch) host layer against the JAX package:
grids, schedules and build_trade_batch bit for bit; import hygiene; the
default device."""
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU at float64)
import numpy as np
import pytest
import torch

from finite_difference_tpu.models.pde import batch as jax_batch
from finite_difference_tpu.models.pde import grid as jax_grid
from finite_difference_tpu_torch.models.pde import batch as port_batch
from finite_difference_tpu_torch.models.pde import grid as port_grid

REPO_ROOT = Path(port_batch.__file__).resolve().parents[3]


def _trade_kwargs(seed=0, B=6, monitor_aligned=False, dyadic_dt=False):
    rng = np.random.default_rng(seed)
    t = 0.25 if dyadic_dt else float(rng.uniform(0.1, 1.0))
    return dict(
        spots=list(rng.uniform(85.0, 115.0, B)),
        strikes=list(rng.uniform(90.0, 110.0, B)),
        sigmas=list(rng.uniform(0.15, 0.45, B)),
        t_expiry=[t] * B,
        r=list(rng.uniform(0.0, 0.1, B)),
        b=list(rng.uniform(-0.02, 0.1, B)),
        is_call=list(rng.integers(0, 2, B) == 1),
        n_time_steps=32 if dyadic_dt else 24,
        monitor_times=[[t * (k + 1) / 5.0 for k in range(5)]] * B,
        lower=[None if i % 3 else 70.0 for i in range(B)],
        upper=[130.0 if i % 2 == 0 else None for i in range(B)],
        rebate=list(rng.uniform(0.0, 2.0, B)),
        rebate_at_hit=list(rng.integers(0, 2, B) == 1),
        num_space_nodes=127,
        monitor_aligned=monitor_aligned,
    )


class TestBuildTradeBatch:
    @pytest.mark.parametrize("use_native", [False, None], ids=["numpy", "default"])
    @pytest.mark.parametrize("monitor_aligned", [False, True])
    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_bit_identical_to_jax(self, use_native, monitor_aligned, dtype):
        # JAX's default route on a uniform schedule is its C++ builder,
        # whose tau_next = dt*(k+1) is bit-identical to the numpy cumsum
        # only where dt is dyadic (see test_native_default_tau_rounding)
        native = use_native is None and not monitor_aligned
        kw = _trade_kwargs(seed=3, monitor_aligned=monitor_aligned, dyadic_dt=native)
        if use_native is not None:
            kw["use_native"] = use_native
        ref = jax_batch.build_trade_batch(dtype=getattr(np, dtype), **kw)
        got = port_batch.build_trade_batch(
            dtype=getattr(torch, dtype), device="cpu", **kw
        )
        for name in port_batch.FIELD_NAMES:
            want = np.asarray(getattr(ref, name))
            have = getattr(got, name).numpy()
            assert have.dtype == want.dtype, name
            np.testing.assert_array_equal(have, want, err_msg=name)

    def test_native_default_tau_rounding(self):
        """The port has only the numpy loop. On a non-dyadic dt the JAX
        default (C++ builder) differs from it, and so from the port, only
        in tau_next: the C++ builder's dt*(k+1) against the loop's running
        sum of dt, a few roundings apart."""
        kw = _trade_kwargs(seed=3)
        ref = jax_batch.build_trade_batch(**kw)
        got = port_batch.build_trade_batch(device="cpu", **kw)
        for name in port_batch.FIELD_NAMES:
            want, have = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
            if name == "tau_next":
                np.testing.assert_allclose(have, want, rtol=1e-14, atol=0)
            else:
                np.testing.assert_array_equal(have, want, err_msg=name)

    def test_batch_from_numpy_carries_a_jax_batch(self):
        ref = jax_batch.build_trade_batch(**_trade_kwargs(seed=5))
        fields = {k: np.asarray(v) for k, v in ref.__dict__.items() if v is not None}
        got = port_batch.batch_from_numpy(fields, device="cpu")
        assert got.batch_size == ref.batch_size and got.n_steps == ref.n_steps
        for name in port_batch.FIELD_NAMES:
            np.testing.assert_array_equal(getattr(got, name).numpy(), fields[name])

    def test_astype_and_slice(self):
        got = port_batch.build_trade_batch(device="cpu", **_trade_kwargs(seed=7))
        f32 = got.astype(torch.float32)
        assert f32.sigma.dtype == torch.float32 and f32.is_call.dtype == torch.bool
        part = got[2:4]
        assert part.batch_size == 2
        np.testing.assert_array_equal(part.dt.numpy(), got.dt.numpy()[2:4])


class TestGrid:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_grids_and_schedules_match_jax(self, seed):
        rng = np.random.default_rng(seed)
        t = float(rng.uniform(0.05, 2.0))
        args = dict(
            spot_eff=float(rng.uniform(80, 120)), strike=float(rng.uniform(80, 120)),
            sigma=float(rng.uniform(0.1, 0.5)), t_expiry=t, num_time_steps=64,
            lower_barrier=float(rng.uniform(50, 75)), upper_barrier=None,
        )
        a, b = port_grid.barrier_log_grid(**args), jax_grid.barrier_log_grid(**args)
        assert (a.x_min, a.dx, a.n_nodes) == (b.x_min, b.dx, b.n_nodes)
        mons = sorted(rng.uniform(0.0, t, 6).tolist()) + [t]
        for fn, kw in (
            ("uniform_schedule", dict(t_expiry=t, n_steps=40, monitor_times=mons)),
            ("monitor_aligned_schedule", dict(t_expiry=t, monitor_times=mons, target_dt=t / 30)),
        ):
            a, b = getattr(port_grid, fn)(**kw), getattr(jax_grid, fn)(**kw)
            for name in ("dt", "theta", "tau_next", "monitor", "div_amount", "reset_lambda"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


class TestPortBoundary:
    IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|finite_difference_tpu)(?:[.\s]|$)", re.M)

    def test_sources_import_no_jax(self):
        sources = sorted((REPO_ROOT / "finite_difference_tpu_torch").rglob("*.py"))
        sources.append(REPO_ROOT / "chip_smoke.py")
        assert len(sources) > 5
        bad = [
            f"{p.relative_to(REPO_ROOT)}: {m.group(0).strip()}"
            for p in sources
            for m in self.IMPORT.finditer(p.read_text())
        ]
        assert not bad, bad

    def test_import_loads_no_jax(self):
        code = (
            "import sys; import finite_difference_tpu_torch.models.pde.batch, "
            "finite_difference_tpu_torch.kernels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'finite_difference_tpu')]; "
            "assert not bad, bad"
        )
        subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, check=True, timeout=120)

    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        kw = _trade_kwargs(seed=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_batch.build_trade_batch(**kw)
        cpu_batch = port_batch.build_trade_batch(device="cpu", **kw)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_batch.price_barrier_batch(cpu_batch, n_nodes=128)

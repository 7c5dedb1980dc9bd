"""Launch the micro-batching pricing server from the command line.

    python -m finite_difference_tpu_torch.serving --port 8777
    python -m finite_difference_tpu_torch.serving --service american --steps 512
    python -m finite_difference_tpu_torch.serving --cpu   # no card

Then::

    curl -s localhost:8777/healthz
    curl -s -X POST localhost:8777/price -d '{"trades": [{"spot": 100,
        "strike": 95, "sigma": 0.3, "t_expiry": 0.25, "r": 0.05,
        "barrier_type": "up-and-out", "upper": 130}]}'

The services run on the card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import threading

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m finite_difference_tpu_torch.serving",
        description="Micro-batching HTTP pricing server",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--service", choices=("barrier", "american"), default="barrier")
    ap.add_argument("--steps", type=int, default=512, help="time steps per grid")
    ap.add_argument("--nodes", type=int, default=None,
                    help="space nodes (default: 1023 barrier / 1022 american)")
    ap.add_argument("--window-ms", type=float, default=5.0,
                    help="micro-batch coalescing window")
    ap.add_argument("--max-bucket", type=int, default=4096)
    ap.add_argument("--route", choices=("pde", "hybrid"), default="pde",
                    help="barrier service: 'hybrid' sends continuous-regime trades "
                         "(FIS n_lim rule) to the analytic sweep with BGK-shifted barriers")
    ap.add_argument("--no-greeks", action="store_true")
    ap.add_argument("--richardson", action="store_true",
                    help="american service: (N, 2N) Richardson pairs — the reference's "
                         "price_log2 convention")
    ap.add_argument("--f32", action="store_true",
                    help="price in float32 instead of float64")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if args.service == "american" and args.route != "pde":
        ap.error("--route applies to the barrier service only")
    if args.richardson and args.service != "american":
        ap.error("--richardson applies to the american service only")
    return args


def make_service(args: argparse.Namespace):
    """The service ``args`` ask for (on the card, or the CPU with ``--cpu``)."""
    from . import AmericanPricingService, BarrierPricingService

    common = dict(
        n_time_steps=args.steps,
        with_greeks=not args.no_greeks,
        dtype=np.float32 if args.f32 else np.float64,
        max_bucket=args.max_bucket,
        device="cpu" if args.cpu else "cuda",
    )
    if args.service == "barrier":
        return BarrierPricingService(
            num_space_nodes=args.nodes or 1023, route=args.route, **common
        )
    return AmericanPricingService(
        num_space_nodes=args.nodes or 1022, richardson=args.richardson, **common
    )


def main(argv=None) -> None:
    from . import PricingServer

    args = parse_args(argv)
    svc = make_service(args)
    server = PricingServer(svc, host=args.host, port=args.port, window_ms=args.window_ms).start()
    print(
        f"{type(svc).__name__} on http://{server.host}:{server.port} "
        f"(grid {args.steps}x{svc.num_space_nodes}, dtype {svc.dtype}, {server.backend}, "
        f"window {args.window_ms} ms) — Ctrl-C to stop"
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.stop()


if __name__ == "__main__":
    main()

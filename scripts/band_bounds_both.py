"""Whether float64 band loops leave the hard input bounds in the JAX package
as they do in the PyTorch port: both packages' band closed loops on the CPU
at float64, on the seeded Shell7x5 candidates of the port's band-limit tool
(``mpc_tuning_tpu_torch.tools.band_spread.band_candidates``: B = 256,
nit = 200, its three capacity buckets).

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 scripts/band_bounds_both.py [--B 256] [--threads 4]

The JAX side runs ``qp_method="pdip_ws_lanes+lp20+split12"`` with
``use_pallas=False`` (its float64 decision-grade band engine); the port
runs its ``band_sim`` engine's plain version (the same schedule: slack
seeding, a 20-iteration stage-0 slack LP, a 12-iteration slack-frozen
stage 2).  Per bucket it prints each package's largest step outside the
bounds (loop units, 0 when every step keeps them), the lanes that leave
them, and the two packages' largest |dU|.  Takes tens of minutes.
"""

from __future__ import annotations

import argparse
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpc_tuning_tpu.cases import shell7x5 as s7_jax  # noqa: E402
from mpc_tuning_tpu.tuning.api import build_problem as build_jax  # noqa: E402
from mpc_tuning_tpu_torch.cases import shell7x5 as s7_torch  # noqa: E402
from mpc_tuning_tpu_torch.tools.band_spread import (  # noqa: E402
    BAND_CAPS, band_candidates, bound_excess)
from mpc_tuning_tpu_torch.tuning.api import build_problem as build_torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--nit", type=int, default=200)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    B, nit = args.B, args.nit
    pj, _ = build_jax(s7_jax.make_case(), dtype=jnp.float64)
    pt, _ = build_torch(s7_torch.make_case(), dtype=torch.float64,
                        device="cpu")
    r_b = np.broadcast_to(pt.r[:nit], (B, nit, 7))
    for caps in BAND_CAPS:
        N, Nu, lam = band_candidates(caps, B, caps[0])
        delta = np.zeros((B, 7))
        t0 = time.perf_counter()
        _, Uj = pj.loop.closed_batch(
            r_b, pj.v, N, Nu, delta, lam, nit, jnp.float64, 12,
            qp_method="pdip_ws_lanes+lp20+split12", use_pallas=False,
            caps=caps)
        Uj = torch.as_tensor(np.array(Uj)).permute(1, 2, 0)
        tj = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, Ut = pt.loop.closed_batch(r_b, pt.v, N, Nu, delta, lam, nit,
                                     torch.float64, 12, engine="band_sim",
                                     device="cpu", caps=caps)
        Ut = Ut.permute(1, 2, 0)
        tt = time.perf_counter() - t0
        out = []
        for tag, U in (("jax", Uj), ("port", Ut)):
            per_lane = [bound_excess(U[:, :, b:b + 1], pt) for b in range(B)]
            lanes = [b for b, e in enumerate(per_lane) if e > 0]
            out.append(f"{tag}: outside by {max(per_lane):.3e} on "
                       f"{len(lanes)} lanes {lanes[:8]}")
        print(f"[{caps} f64 B={B} nit={nit}] " + " | ".join(out)
              + f" | max |U_jax - U_port| {float((Uj - Ut).abs().max()):.3e}"
              f" | jax {tj:.1f} s, port {tt:.1f} s", flush=True)


if __name__ == "__main__":
    main()

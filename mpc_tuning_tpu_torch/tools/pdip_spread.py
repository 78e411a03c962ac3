"""The float32 hold of a whole-sim PDIP loop: the kernel's U against correct
plain runs.

A float32 PDIP of a few iterations run to its floor turns a last-digit
difference in its warm start into another iterate, so two correct float32
loops can part on a lane by more than the U cap: on an H100, the plain
loop with two row-sum orders following the same kernel U reads 6.3e-04
and 0.157 on lane 11 of the Wood-Berry (127, 15) test batch (B = 18, nit
60; PERF.md §6). The hold therefore takes a lane over the cap to
correct runs one rounding away, as the band gate does
(``tools/band_spread``): the plain loop following the kernel's U moved by
ULP_MOVES ulps (``torch.nextafter``), each step's QP solved from a state
a rounding away. The lane passes if one of them stays within the cap of
the kernel's U at every step. A wrong answer at a step is no such run's:
each run follows the kernel's U but solves every step itself.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ULP_MOVES", "ulp_moved", "pdip_u_hold"]

ULP_MOVES = (-1, 1, -2, 2)


def ulp_moved(U, k):
    """U moved by k ulps (toward -inf for k < 0)."""
    to = torch.full_like(U, math.copysign(math.inf, k))
    for _ in range(abs(k)):
        U = torch.nextafter(U, to)
    return U


def pdip_u_hold(plain, args, kwargs, Y, U, gate, cap, median=True):
    """Hold a float32 whole-sim PDIP run, Y and U (nit, k, B), against
    ``plain(*args, **kwargs, u_follow=...)`` (its plain version on the same
    inputs): Y within ``gate`` on every lane; U within ``gate`` on the
    median lane (``median``) and within ``cap`` on every lane, a lane over
    the cap passing if a plain run following U moved by one of ULP_MOVES
    ulps is within the cap of it.  Returns (ok, text)."""
    lane_max = lambda d: d.abs().amax((0, 1))
    Yp, Up = plain(*args, **kwargs, u_follow=U)[:2]
    dy, du = lane_max(Y - Yp), lane_max(U - Up)
    ey, eu, med = float(dy.max()), float(du.max()), float(du.median())
    text = f"Y {ey:.3e} U {eu:.3e} (median lane {med:.3e})"
    ok = ey <= gate and (not median or med <= gate)
    over = [int(b) for b in torch.nonzero(~(du <= cap)).flatten()]
    if over:
        found = {}
        for k in ULP_MOVES:
            duk = lane_max(U - plain(*args, **kwargs,
                                     u_follow=ulp_moved(U, k))[1])
            found.update({b: (k, float(duk[b])) for b in over
                          if b not in found and float(duk[b]) <= cap})
            if len(found) == len(over):
                break
        ok = ok and len(found) == len(over)
        text += "; lanes over the cap " + ", ".join(
            f"{b} (U {float(du[b]):.3e}; "
            + (f"{found[b][0]:+d} ulp run {found[b][1]:.3e})" if b in found
               else "no run one rounding away within it)")
            for b in over)
    return ok, text

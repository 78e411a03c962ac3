"""The port's fixed-tuning demos against the JAX package's at float64 on
the CPU: the Shell3x3 linear MPC (nominal, mismatched, and reloaded from a
committed checkpoint; closed loop through the cold masked PDIP 'pdip'; the
Van de Vusse NMPC demo: tests/test_torch_demos_nmpc.py).

The Shell3x3 loops are held at 1e-10 or at twice what two correct JAX
engines ('pdip' and 'pdip_dense', both run to the same 30-iteration
floor) differ by on the same loop, whichever is larger: at step 87 of the
nominal loop (nit 120) the QP sits at its rounding floor, where those two
JAX engines part by 1.5e-10 in U and the port's 'pdip' by as much."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cases import demos as demos_jax
from mpc_tuning_tpu.cases import shell3x3 as s3_jax
from mpc_tuning_tpu.models import plants as plants_jax
from mpc_tuning_tpu.sim.mpc_loop import MPCLoop as MPCLoopJax
from mpc_tuning_tpu.tuning.api import build_problem as build_jax
from mpc_tuning_tpu_torch.cases import demos as demos_torch
from mpc_tuning_tpu_torch.cases.cross_eval import REPO_ROOT
from mpc_tuning_tpu_torch.ops import kernels

torch.set_num_threads(1)  # B = 1: threads only contend with other workers

NIT = 120
CHECKPOINT = str(REPO_ROOT / "checkpoints"
                 / "Shell3x3_refscale_Tuning_21Aug2026_06_30.npz")


def _jax_witness(t, nit, nominal):
    """The JAX demo's closed loop through 'pdip_dense' in place of 'pdip'
    (raw units): a second correct run of the same loop."""
    case = s3_jax.make_case(nit=nit)
    problem, _ = build_jax(case, dtype=jnp.float64, L=t["L"], R=t["R"])
    real = (plants_jax.shell3x3() if nominal
            else plants_jax.shell3x3(0.2, 0.2, 0.3))
    plant_c = real.G.scaled(t["L"], t["R"]).c2d(case.Ts).to_ss()
    loop = MPCLoopJax(ctl=problem.loop.ctl, plant_ss=plant_c)
    y_c, u_c = loop.simulate(problem.r, problem.v, nit, int(t["N"]),
                             int(np.max(t["Nu"])), t["delta"], t["lam"],
                             qp_method="pdip_dense")
    return ((np.linalg.inv(t["L"]) @ np.asarray(y_c).T).T,
            np.asarray(u_c) * np.diag(t["R"])[None, :])


@pytest.mark.parametrize("nominal,checkpoint", [
    (True, None), (False, None), (True, CHECKPOINT)],
    ids=["nominal", "mismatched", "checkpoint"])
def test_shell3x3_demo_matches_jax(nominal, checkpoint):
    kernels.reset_launches()
    case, t, (y, u) = demos_torch.shell3x3_demo(
        nit=NIT, checkpoint=checkpoint, nominal=nominal, device="cpu")
    assert set(kernels.launch_counts().values()) == {0}
    case_j, t_j, (y_j, u_j) = demos_jax.shell3x3_demo(
        nit=NIT, checkpoint=checkpoint, nominal=nominal)
    assert case.nit == case_j.nit == NIT
    for k in ("N", "Nu", "delta", "lam", "L", "R"):
        assert np.array_equal(np.asarray(t[k]), np.asarray(t_j[k])), k
    y_w, u_w = _jax_witness(t_j, NIT, nominal)
    for a, b, w in ((y, y_j, y_w), (u, u_j, u_w)):
        lim = max(1e-10, 2.0 * float(np.abs(w - b).max()))
        assert a.shape == (NIT, 3) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=lim)


def test_demos_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        demos_torch.shell3x3_demo(nit=20)
    with pytest.raises(RuntimeError):
        demos_torch.vandevusse_demo(nit=5)

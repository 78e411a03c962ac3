"""Time the PyTorch port's whole-sim tracking kernels of one source tree and
fingerprint their outputs, to compare two trees on the same card.

    python scripts/ab_whole_sim.py ROOT

ROOT is a checkout of the repo (for example a ``git archive`` of the parent
commit unpacked into a gitignored directory); its ``chip_smoke.py`` and
``mpc_tuning_tpu_torch`` are imported.  It runs ``closed_sim_admm`` at the
VNS headline shape (Wood-Berry, B = 8192, caps (64, 8), nit 400, 40
iterations, float32) and ``closed_sim_pdip`` at the GAM shape (B = 2048,
(N, Nu) = (20, 4), caps (32, 4), 15 iterations, float32), as
``chip_smoke.py`` phase 4 does, and prints each one's mean of 3 launches
after a warm-up (CUDA events) and a SHA-256 prefix of its (Y, U).  Run the
trees in turn in one call (parent, change, change, parent): equal digests
show bitwise-equal results.  Needs one CUDA card.
"""

import hashlib
import sys

root = sys.argv[1]
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mpc_tuning_tpu_torch.cases import woodberry  # noqa: E402
from mpc_tuning_tpu_torch.ops import kernels as K  # noqa: E402
from mpc_tuning_tpu_torch.tuning.api import build_problem  # noqa: E402

assert K.__file__.startswith(root), K.__file__
digest = lambda out: hashlib.sha256(b"".join(
    x.cpu().numpy().tobytes() for x in out)).hexdigest()[:12]
problem, _ = build_problem(woodberry.make_case(), device="cuda")
f32 = torch.float32
inp, N, Nu = cs.sim_inputs(problem, (64, 8), 8192, 400, f32, "admm_sim", 1)
args = (*inp[:4], 400, 40, 1e-6, 1.6, inp[4])
admm, oa = cs.timed(lambda: K.closed_sim_admm(*args), 3)
inp, N, Nu = cs.sim_inputs(problem, (32, 4), 2048, 400, f32, "pdip_sim", 2,
                           N=20, Nu=4)
args = (*inp[:4], 400, 15, inp[4])
pdip, op = cs.timed(lambda: K.closed_sim_pdip(*args), 3)
print(f"AB {root}: closed_sim_admm {admm:.1f} ms (Y,U sha {digest(oa)}) "
      f"closed_sim_pdip {pdip:.1f} ms (Y,U sha {digest(op)})", flush=True)

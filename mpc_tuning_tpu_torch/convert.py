"""State carried across the two packages.

* ``arrays_from_numpy`` turns the JAX package's ``MPCLoop.arrays()`` dict
  (after ``np.asarray`` on each value) into the port's tensor dict — the
  same dict the port's own ``MPCLoop.arrays()`` builds.
* ``dtc_constants_from_numpy`` turns the JAX package's
  ``DTCGPC.scan_constants()`` dict (after ``np.asarray`` on each value)
  into the port's tensors, the dict ``sim/gpc_loop.scan_loop`` takes.
* ``nmpc_spec_from_numpy`` turns the fields of the JAX package's
  ``NMPCSpec`` (after ``np.asarray`` on each array) into the port's
  ``NMPCSpec`` around the port's own rhs, so both packages simulate the
  same controller.
* Tuning results need no conversion: both packages write and read the same
  ``<case>_tuning_state.json`` schema (``tuning.api.hybrid_tune``) and the
  same checkpoint files (``utils.io``).
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_tuning_tpu_torch.models.ode import vandevusse_rhs
from mpc_tuning_tpu_torch.ops.kernels import require_device
from mpc_tuning_tpu_torch.sim.gpc_loop import SCAN_KEYS
from mpc_tuning_tpu_torch.sim.nmpc_loop import NMPCSpec

__all__ = ["arrays_from_numpy", "dtc_constants_from_numpy",
           "nmpc_spec_from_numpy"]


def arrays_from_numpy(c: dict, dtype=torch.float64, device="cuda") -> dict:
    require_device(device)
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in c.items()}


def dtc_constants_from_numpy(c: dict, dtype=torch.float64,
                             device="cuda") -> dict:
    """The DTC-GPC step's constants: every key of
    ``sim/gpc_loop.SCAN_KEYS``, NumPy arrays, as tensors on ``device``."""
    require_device(device)
    missing = set(SCAN_KEYS) - set(c)
    if missing:
        raise ValueError(f"DTC-GPC constants missing {sorted(missing)}")
    return {k: torch.as_tensor(np.array(c[k], dtype=np.float64), dtype=dtype,
                               device=device) for k in SCAN_KEYS}


def nmpc_spec_from_numpy(fields: dict, rhs=vandevusse_rhs) -> NMPCSpec:
    """``fields``: every NMPCSpec field but ``rhs`` (a JAX function, which
    does not carry over), arrays as NumPy; ``rhs``: the port's model."""
    if "rhs" in fields:
        raise ValueError("pass the port's model as rhs; the JAX rhs does not "
                         "carry over")
    return NMPCSpec(rhs=rhs, **{
        k: np.array(v, dtype=np.float64) if isinstance(v, np.ndarray) else v
        for k, v in fields.items()})

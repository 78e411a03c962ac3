"""State carried across the two packages.

* ``arrays_from_numpy`` turns the JAX package's ``MPCLoop.arrays()`` dict
  (after ``np.asarray`` on each value) into the port's tensor dict — the
  same dict the port's own ``MPCLoop.arrays()`` builds.
* Tuning results need no conversion: both packages write and read the same
  ``<case>_tuning_state.json`` schema (``tuning.api.hybrid_tune``) and the
  same checkpoint files (``utils.io``).
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_tuning_tpu_torch.ops.kernels import require_device

__all__ = ["arrays_from_numpy"]


def arrays_from_numpy(c: dict, dtype=torch.float64, device="cuda") -> dict:
    require_device(device)
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in c.items()}

"""Plant & model representation: continuous transfer-function matrices
with io-delays, exact ZOH discretization, discrete state-space
realizations, trajectory rollout and the benchmark plant definitions."""

from mpc_tuning_tpu_torch.models.poly import (  # noqa: F401
    polyconv,
    polyfromroots,
    polytrim,
    row_common_den,
)
from mpc_tuning_tpu_torch.models.lti import (  # noqa: F401
    TransferFunction,
    DiscreteSS,
    c2d_channel,
    tfm,
    tf,
)
from mpc_tuning_tpu_torch.models.simulate import dlsim, dlsim_torch  # noqa: F401

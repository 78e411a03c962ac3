"""Benchmark case studies with the reference's exact configurations."""

from mpc_tuning_tpu_torch.cases import (  # noqa: F401
    shell3x3, shell7x5, vandevusse, woodberry)

"""Hybrid auto-tuning: goal-attainment (continuous weights) alternated with
Variable Neighborhood Search (integer horizons), per Giraldo, Melo,
Secchi, "Tuning of Model Predictive Controllers Based on Hybrid
Optimization", Processes 10(2):351, 2022."""

from mpc_tuning_tpu_torch.tuning.api import mpc_tuning, TuningResult  # noqa: F401

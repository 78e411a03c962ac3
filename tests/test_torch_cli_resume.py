"""The port's CLI --resume: a finished Wood-Berry tune's state (the JAX
package's run_main with --cpu on tests/test_cli.py's arguments; both
packages write one schema) resumed by the port's run_main reproduces the
run: the same N and Nu, delta, lambda and Fvns at 1e-8 relative, as
tests/test_torch_cli.py holds the port's uninterrupted run."""

import shutil

import torch

from mpc_tuning_tpu.cli import run_main as run_jax
from mpc_tuning_tpu_torch.cli import run_main as run_torch
from test_torch_cli import ARGS, _payload, assert_same_tune

torch.set_num_threads(1)  # B <= 16: threads only contend with other workers


def test_cli_resume_reproduces_the_run(tmp_path, capsys):
    run_jax(ARGS + ["--checkpoint-dir", str(tmp_path / "jax"), "--cpu"])
    ref = _payload(capsys)
    state = tmp_path / "torch" / "woodberry_tuning_state.json"
    state.parent.mkdir()
    shutil.copy(tmp_path / "jax" / "woodberry_tuning_state.json", state)
    run_torch(ARGS + ["--checkpoint-dir", str(state.parent), "--cpu",
                      "--resume"])
    assert_same_tune(_payload(capsys), ref)

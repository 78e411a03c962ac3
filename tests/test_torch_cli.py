"""The port's CLI (``mpc-tuning-run-torch``) against the JAX package's
``run_main`` with --cpu on tests/test_cli.py's arguments: a tiny Wood-Berry
tune at float64 (same N and Nu; delta, lambda and Fvns at 1e-8 relative)
and its report, the refusals and the card's precision rule (--resume:
tests/test_torch_cli_resume.py; the port's tune takes ~5 min on one CPU
core, its joint weight polish scoring one candidate a call)."""

import json

import numpy as np
import pytest
import torch

from mpc_tuning_tpu.cli import run_main as run_jax
from mpc_tuning_tpu_torch.cli import card_dtype, run_main as run_torch

torch.set_num_threads(1)  # B <= 16: threads only contend with other workers

ARGS = ["woodberry", "--nit", "40", "--nbp", "4", "--nbc", "2", "--budget",
        "small"]


def _payload(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def assert_same_tune(payload, ref):
    """The same case, N and Nu; delta, lambda and Fvns at 1e-8 relative."""
    assert payload["case"] == ref["case"] == "woodberry"
    assert payload["N"] == ref["N"] and payload["Nu"] == ref["Nu"]
    for k in ("delta", "lam", "Fvns"):
        assert _rel(payload[k], ref[k]) <= 1e-8, (k, payload[k], ref[k])


def test_cli_matches_jax_and_reports(tmp_path, capsys):
    run_jax(ARGS + ["--checkpoint-dir", str(tmp_path / "jax"), "--cpu"])
    ref = _payload(capsys)
    ckpt = str(tmp_path / "torch")
    report = str(tmp_path / "rep.html")
    out = run_torch(ARGS + ["--checkpoint-dir", ckpt, "--cpu", "--report",
                            report])
    payload = _payload(capsys)
    assert payload == json.loads(json.dumps(out))
    assert set(payload) == set(ref) | {"report"}
    assert_same_tune(payload, ref)
    assert (tmp_path / "torch" / "woodberry_tuning_state.json").exists()
    assert payload["checkpoint"].startswith(ckpt)

    assert payload["report"] == report
    with open(report) as fh:
        html = fh.read()
    assert html.count("data:image/png;base64,") == 3  # closed/verify/history
    assert "woodberry" in html and "<table>" in html


def test_cli_mesh_raises(tmp_path):
    """--mesh takes 'auto' or a positive shard count (a sharded tune:
    tests/test_torch_parallel.py); anything else raises before a tune."""
    for bad in ("0", "two"):
        with pytest.raises(ValueError):
            run_torch(ARGS + ["--checkpoint-dir", str(tmp_path), "--cpu",
                              "--mesh", bad])


def test_cli_needs_the_card_without_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_torch(ARGS + ["--checkpoint-dir", str(tmp_path)])


@pytest.mark.parametrize("case,dtype", [
    ("woodberry", torch.float32), ("shell3x3", torch.float32),
    ("vandevusse", torch.float32), ("shell7x5", torch.float64)])
def test_card_precision_rule(case, dtype):
    """float32 on the card where the case's entry point takes it; the band
    case Shell7x5 at float64, the only dtype its loops run at."""
    assert card_dtype(case) == dtype

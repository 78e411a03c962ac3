"""The port's report generator against the JAX package's on the inputs of
tests/test_report.py: the HTML file and the PNG files are equal byte for
byte (matplotlib's Agg PNG carries no time stamp, so no field is
removed)."""

import os

import numpy as np
import pytest

from mpc_tuning_tpu.report import generate_report as report_jax
from mpc_tuning_tpu_torch.report import generate_report as report_torch


def _fake_case(ny=7, nu=3, nit=60):
    rng = np.random.default_rng(0)
    t = np.arange(nit) * 4.0
    Y = np.cumsum(rng.normal(0, 0.02, (nit, ny)), axis=0)
    U = np.clip(np.cumsum(rng.normal(0, 0.05, (nit, nu)), axis=0), -0.5, 0.5)
    r = np.zeros((nit, ny))
    Yref = 0.9 * Y + 0.01
    ymin = np.full(ny, -0.5)
    ymax = np.full(ny, 0.5)
    ymin[-1] = -np.inf  # one-sided / unbounded entries must not break
    hist = [dict(it=0, Fgam=120.0, Fvns=900.0),
            dict(it=1, Fgam=80.0, Fvns=350.0),
            dict(it="polish", Fvns=340.0)]
    return t, Y, U, r, Yref, ymin, ymax, hist


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_html_report_equals_jax(tmp_path):
    t, Y, U, r, Yref, ymin, ymax, hist = _fake_case()
    kw = dict(r=r, Yref=Yref, ymin=ymin, ymax=ymax, Yc=Y, Yo=Yref,
              history=hist, summary=dict(N=27, Nu=[2, 2, 2]))
    out = {}
    for name, fn in (("jax", report_jax), ("torch", report_torch)):
        os.makedirs(tmp_path / name)
        path = str(tmp_path / name / "rep.html")
        assert fn(path, "Shell7x5", t, Y, U, **kw) == path
        out[name] = _read(path)
    assert out["torch"].count(b"data:image/png;base64,") == 3
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("ny,nu,with_verify", [(2, 2, False), (3, 3, True)])
def test_png_report_equals_jax(tmp_path, ny, nu, with_verify):
    t, Y, U, r, Yref, ymin, ymax, hist = _fake_case(ny=ny, nu=nu)
    kw = dict(r=r, Yref=Yref, history=hist)
    if with_verify:
        kw.update(Yc=Y, Yo=Yref)
    files = {}
    for name, fn in (("jax", report_jax), ("torch", report_torch)):
        os.makedirs(tmp_path / name)
        stem = str(tmp_path / name / "rep")
        assert fn(stem + ".png", "WoodBerry", t, Y, U, **kw) == \
            stem + "_closed.png"
        files[name] = sorted(os.listdir(tmp_path / name))
    parts = ["closed", "history"] + (["verify"] if with_verify else [])
    assert files["torch"] == files["jax"] == sorted(f"rep_{p}.png"
                                                    for p in parts)
    for f in files["torch"]:
        assert _read(tmp_path / "torch" / f) == _read(tmp_path / "jax" / f), f


def test_saved_inputs_render_the_same_report(tmp_path):
    """An .npz report keeps the figures' inputs (no matplotlib needed);
    rendered later it is the HTML generate_report writes directly."""
    from mpc_tuning_tpu_torch.report import figure_count, render_saved

    t, Y, U, r, Yref, ymin, ymax, hist = _fake_case()
    kw = dict(r=r, Yref=Yref, ymin=ymin, ymax=ymax, Yc=Y, Yo=Yref,
              history=hist, summary=dict(N=27, Nu=[2, 2, 2], Fvns=340.5))
    saved = str(tmp_path / "rep.npz")
    assert report_torch(saved, "Shell7x5", t, Y, U, **kw) == saved
    assert figure_count(saved) == 3
    direct = str(tmp_path / "direct.html")
    report_torch(direct, "Shell7x5", t, Y, U, **kw)
    later = render_saved(saved, str(tmp_path / "later.html"))
    assert figure_count(later) == 3
    assert _read(later) == _read(direct)
    bare = str(tmp_path / "bare.npz")
    report_torch(bare, "WoodBerry", t, Y, U)
    assert figure_count(bare) == 1

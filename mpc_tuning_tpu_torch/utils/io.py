"""Tuning checkpoint save/load.

Equivalent of the reference's ``<caller>_Tuning_<datestamp>.mat`` artifacts
written by MPCTuning.m:370-381 (schema: Tuning_Parameters struct with
mpcobj horizons/weights + scale matrices), reproducible via the
``tuning=false`` reload path of the drivers (WoodBerry.m:163-178).

We store a .npz with the same logical fields; json sidecar for humans.
"""

from __future__ import annotations

import datetime
import json
import pathlib

import numpy as np

__all__ = ["save_tuning", "load_tuning"]


def save_tuning(path, name: str, N, Nu, delta, lam, L, R, Fob, meta=None) -> str:
    stamp = datetime.datetime.now().strftime("%d%b%Y_%H_%M")
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    fname = path / f"{name}_Tuning_{stamp}.npz"
    np.savez(
        fname,
        N=np.asarray(N), Nu=np.asarray(Nu),
        delta=np.asarray(delta), lam=np.asarray(lam),
        L=np.asarray(L), R=np.asarray(R), Fob=np.asarray(Fob),
    )
    side = {
        "name": name, "date": stamp,
        "N": int(np.max(N)), "Nu": np.asarray(Nu).tolist(),
        "delta": np.asarray(delta).tolist(), "lambda": np.asarray(lam).tolist(),
        "meta": meta or {},
    }
    with open(str(fname).replace(".npz", ".json"), "w") as f:
        json.dump(side, f, indent=1)
    return str(fname)


def load_tuning(fname) -> dict:
    d = np.load(fname, allow_pickle=False)
    return {k: d[k] for k in d.files}

"""Figure/report generator (the port of the JAX package's ``report.py``;
NumPy trajectories in, matplotlib with the Agg backend) — the observable
tail of every reference driver (MPC-Tuning/WoodBerry.m:186-251,
Shell3x3.m:195-300, Shell7x5.m:242-291, VanDeVusse_NMPC.m:226-274 plot the
closed loop, the open-vs-closed horizon verification, and echo the tuning
progress).

``generate_report`` renders the reference's figure sets to PNG or a single
self-contained HTML file (CLI: ``mpc-tuning-run-torch <case> --report
out.html``).  Same figures, styles and HTML as the JAX package's, so the
same inputs give the same bytes.

Charts follow the repo's viz conventions: fixed-order categorical palette
(validated for adjacent-pair CVD separation), one axis per chart, small
multiples for >4 outputs, recessive grids, band limits as neutral shaded
regions, and no dual axes.
"""

from __future__ import annotations

import base64
import io
import json
import os

import numpy as np

__all__ = ["generate_report", "render_saved", "figure_count",
           "fig_closed_loop", "fig_open_vs_closed", "fig_tuning_history"]

# validated default categorical palette (fixed slot order — never cycled)
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT2 = "#52514e"
GRID = "#e7e6e2"
BAND = "#d9d8d3"


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax, title=None, xlabel=None, ylabel=None):
    ax.set_facecolor(SURFACE)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.tick_params(colors=TEXT2, labelsize=8)
    ax.grid(True, color=GRID, linewidth=0.6, alpha=0.8)
    ax.set_axisbelow(True)
    if title:
        ax.set_title(title, color=TEXT, fontsize=9, loc="left")
    if xlabel:
        ax.set_xlabel(xlabel, color=TEXT2, fontsize=8)
    if ylabel:
        ax.set_ylabel(ylabel, color=TEXT2, fontsize=8)


def _grid_dims(n):
    cols = 1 if n == 1 else (2 if n <= 6 else 3)
    rows = -(-n // cols)
    return rows, cols


def fig_closed_loop(t, Y, U, r=None, Yref=None, ymin=None, ymax=None,
                    title="Closed loop"):
    """Small-multiples y_i (with setpoint / desired-response / band
    overlays) above a MV panel — the WoodBerry.m:266-281 final-sim figure.

    Y (nit, ny), U (nit, nu); r/Yref same shape as Y or None; ymin/ymax
    per-output band limits (entries may be +-inf)."""
    plt = _mpl()
    Y = np.asarray(Y)
    U = np.asarray(U)
    ny, nu = Y.shape[1], U.shape[1]
    rows, cols = _grid_dims(ny)
    fig, axes = plt.subplots(rows + 1, cols,
                             figsize=(3.4 * cols, 1.9 * (rows + 1)),
                             squeeze=False)
    fig.patch.set_facecolor(SURFACE)
    for i in range(ny):
        ax = axes[i // cols][i % cols]
        _style(ax, title=f"y{i + 1}")
        if ymin is not None and np.isfinite(ymin[i]) and \
                ymax is not None and np.isfinite(ymax[i]):
            ax.axhspan(float(ymin[i]), float(ymax[i]), color=BAND,
                       alpha=0.5, lw=0, label="band")
        if r is not None:
            ax.plot(t, np.asarray(r)[:, i], color=TEXT2, lw=1.0, ls="--",
                    label="setpoint")
        if Yref is not None:
            ax.plot(t, np.asarray(Yref)[:, i], color=PALETTE[1], lw=1.2,
                    ls=":", label="desired (Yref)")
        ax.plot(t, Y[:, i], color=PALETTE[0], lw=1.6, label="closed loop")
        if i == 0:
            ax.legend(fontsize=7, frameon=False, labelcolor=TEXT2)
    for j in range(ny, rows * cols):
        axes[j // cols][j % cols].set_visible(False)
    # MV panel(s) along the last row
    for j in range(cols):
        ax = axes[rows][j]
        if j == 0:
            _style(ax, title="manipulated variables", xlabel="k")
            for i in range(nu):
                ax.step(t, U[:, i], where="post",
                        color=PALETTE[i % len(PALETTE)], lw=1.2,
                        label=f"u{i + 1}")
            ax.legend(fontsize=7, frameon=False, ncol=1, labelcolor=TEXT2,
                      loc="upper left", bbox_to_anchor=(1.01, 1.0))
        else:
            ax.set_visible(False)
    fig.suptitle(title, color=TEXT, fontsize=11, x=0.02,
                 horizontalalignment="left")
    fig.tight_layout(rect=(0, 0, 1, 0.96))
    return fig


def fig_open_vs_closed(t, Yc, Yo, title="Horizon verification: "
                       "receding-horizon vs single-shot open loop"):
    """The open-vs-closed sanity figure (WoodBerry.m:186-232): with
    well-chosen horizons the two nearly coincide."""
    plt = _mpl()
    Yc = np.asarray(Yc)
    Yo = np.asarray(Yo)
    ny = Yc.shape[1]
    rows, cols = _grid_dims(ny)
    fig, axes = plt.subplots(rows, cols, figsize=(3.4 * cols, 1.9 * rows),
                             squeeze=False)
    fig.patch.set_facecolor(SURFACE)
    for i in range(ny):
        ax = axes[i // cols][i % cols]
        _style(ax, title=f"y{i + 1}",
               xlabel="k" if i // cols == rows - 1 else None)
        ax.plot(t, Yc[:, i], color=PALETTE[0], lw=1.6, label="closed loop")
        ax.plot(t, Yo[:, i], color=PALETTE[1], lw=1.4, ls="--",
                label="open loop (single shot)")
        if i == 0:
            ax.legend(fontsize=7, frameon=False, labelcolor=TEXT2)
    for j in range(ny, rows * cols):
        axes[j // cols][j % cols].set_visible(False)
    fig.suptitle(title, color=TEXT, fontsize=11, x=0.02,
                 horizontalalignment="left")
    fig.tight_layout(rect=(0, 0, 1, 0.94))
    return fig


def fig_tuning_history(history, title="Tuning progress"):
    """Objective incumbents per alternation (the tuner's disp lines,
    MPC_TFob.m:104-105 / VNS2.m:200).  Two panels (different scales —
    never a dual axis): GAM cost and VNS objective."""
    plt = _mpl()
    hist = [h for h in history if not isinstance(h.get("it"), str)]
    its = [h["it"] for h in hist]
    fg = [h.get("Fgam") for h in hist]
    fv = [h.get("Fvns") for h in hist]
    fig, axes = plt.subplots(1, 2, figsize=(6.8, 2.4), squeeze=False)
    fig.patch.set_facecolor(SURFACE)
    panels = [("GAM cost Fgam", fg, PALETTE[0]),
              ("VNS objective Fvns", fv, PALETTE[1])]
    for j, (name, vals, color) in enumerate(panels):
        ax = axes[0][j]
        _style(ax, title=name, xlabel="alternation")
        ok = [(i, v) for i, v in zip(its, vals) if v is not None]
        if ok:
            ax.plot([i for i, _ in ok], [v for _, v in ok], color=color,
                    lw=1.6, marker="o", ms=4)
        if any(v is not None and v > 0 for _, v in ok) and len(ok) > 1:
            vmax = max(v for _, v in ok)
            vmin = min(v for _, v in ok)
            if vmin > 0 and vmax / max(vmin, 1e-12) > 50:
                ax.set_yscale("log")
    fig.suptitle(title, color=TEXT, fontsize=11, x=0.02,
                 horizontalalignment="left")
    fig.tight_layout(rect=(0, 0, 1, 0.93))
    return fig


def _png_b64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=130, facecolor=SURFACE)
    return base64.b64encode(buf.getvalue()).decode()


def generate_report(out_path: str, case_name: str, t, Y, U, *,
                    r=None, Yref=None, ymin=None, ymax=None,
                    Yc=None, Yo=None, history=None, summary: dict | None
                    = None) -> str:
    """Render the reference's figure sets for one tuned case.

    out_path ending in .html -> one self-contained HTML file (figures
    embedded as base64 PNGs + a summary table); ending in .npz -> the
    figures' inputs, unrendered (no matplotlib needed; ``render_saved``
    draws them later, on a host that has it); any other extension ->
    <stem>_closed.png / _verify.png / _history.png next to it.
    Returns the path written."""
    if out_path.endswith(".npz"):
        return _save_inputs(out_path, case_name, t, Y, U, r=r, Yref=Yref,
                            ymin=ymin, ymax=ymax, Yc=Yc, Yo=Yo,
                            history=history, summary=summary)
    figs = [("closed", fig_closed_loop(
        t, Y, U, r=r, Yref=Yref, ymin=ymin, ymax=ymax,
        title=f"{case_name}: closed loop at tuned parameters"))]
    if Yc is not None and Yo is not None:
        figs.append(("verify", fig_open_vs_closed(t, Yc, Yo)))
    if history:
        figs.append(("history", fig_tuning_history(history)))

    if out_path.endswith(".html"):
        rows = ""
        if summary:
            cells = "".join(
                f"<tr><td>{k}</td><td><code>{v}</code></td></tr>"
                for k, v in summary.items())
            rows = (f"<table><thead><tr><th>parameter</th><th>value</th>"
                    f"</tr></thead><tbody>{cells}</tbody></table>")
        imgs = "".join(
            f'<figure><img alt="{name}" '
            f'src="data:image/png;base64,{_png_b64(f)}"/></figure>'
            for name, f in figs)
        html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{case_name} tuning report</title><style>
body{{background:{SURFACE};color:{TEXT};font:14px system-ui;margin:2rem;}}
h1{{font-size:1.3rem}} figure{{margin:1rem 0}} img{{max-width:100%}}
table{{border-collapse:collapse;margin:.5rem 0}}
td,th{{border:1px solid {GRID};padding:.25rem .6rem;text-align:left;
color:{TEXT2}}} th{{color:{TEXT}}}
</style></head><body><h1>{case_name} — MPC tuning report</h1>
{rows}{imgs}</body></html>"""
        with open(out_path, "w") as fh:
            fh.write(html)
    else:
        stem, _ = os.path.splitext(out_path)
        paths = []
        for name, f in figs:
            p = f"{stem}_{name}.png"
            f.savefig(p, dpi=130, facecolor=SURFACE)
            paths.append(p)
        out_path = paths[0]
    import matplotlib.pyplot as plt

    plt.close("all")
    return out_path


# keyword inputs of generate_report kept as JSON text in a saved .npz
_JSON_INPUTS = ("history", "summary")


def _save_inputs(out_path, case_name, t, Y, U, **kw) -> str:
    arrays = {k: np.asarray(v) for k, v in kw.items()
              if v is not None and k not in _JSON_INPUTS}
    text = {k: json.dumps(kw[k]) for k in _JSON_INPUTS if kw[k] is not None}
    np.savez(out_path, case_name=np.asarray(case_name), t=np.asarray(t),
             Y=np.asarray(Y), U=np.asarray(U), json=json.dumps(text),
             **arrays)
    return out_path


def render_saved(npz_path: str, out_path: str) -> str:
    """Render the figure inputs that ``generate_report`` saved to
    ``npz_path`` (an out_path ending in .npz) as ``out_path`` (.html or
    PNGs).  Returns the path written."""
    with np.load(npz_path, allow_pickle=False) as d:
        kw = {k: d[k] for k in d.files}
    case_name = str(kw.pop("case_name"))
    kw.update({k: json.loads(v)
               for k, v in json.loads(str(kw.pop("json"))).items()})
    return generate_report(out_path, case_name, kw.pop("t"), kw.pop("Y"),
                           kw.pop("U"), **kw)


def figure_count(path: str) -> int:
    """Figures a report holds: embedded PNGs of an .html file, figure sets
    of saved inputs (.npz: the closed loop, the horizon verification where
    both legs are there, the history where it has entries)."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as d:
            text = json.loads(str(d["json"]))
            return (1 + ("Yc" in d.files and "Yo" in d.files)
                    + bool(json.loads(text.get("history", "null"))))
    with open(path) as fh:
        return fh.read().count("data:image/png;base64,")

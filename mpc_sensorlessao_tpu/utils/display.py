"""Display helpers: phase maps, PSFs, telemetry traces, polar surfaces.

The reference drives interactive MATLAB figures all over its display
surface -- `telescopeAbstract.imagesc` (telescopeAbstract.m:496-560),
`stochasticWave` displays, `utilities.polar3` (utilities.m:427-487), and
the `realTimeDisplay` workstation class.  The equivalent here is
headless-friendly: each helper builds a matplotlib figure (Agg-safe,
lazily imported so the compute path never touches matplotlib), returns
it, and optionally saves to a file -- the natural workflow on a remote
accelerator host where "display" means writing a PNG next to the run
artifacts.

All helpers accept jax or numpy arrays (converted on entry; device
arrays are fetched once).
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _finish(fig, save, close):
    if save is not None:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    if close:
        # pyplot keeps every figure alive in its global registry; a
        # per-step/per-cell loop that only wants the PNG must close or
        # it leaks a rendered figure per call
        import matplotlib.pyplot as plt
        plt.close(fig)
    return fig


def show_phase(phase, mask=None, title: str = "phase [rad]",
               save: str | None = None, close: bool = False):
    """Pupil phase map with the outside-pupil region blanked
    (telescopeAbstract.imagesc semantics: NaN outside the pupil)."""
    plt = _mpl()
    ph = np.asarray(phase, dtype=np.float64).copy()
    if mask is not None:
        ph[~np.asarray(mask, dtype=bool)] = np.nan
    fig, ax = plt.subplots(figsize=(4.2, 4))
    im = ax.imshow(ph, origin="lower", cmap="RdBu_r")
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.colorbar(im, ax=ax, shrink=0.85)
    return _finish(fig, save, close)


def show_psf(image, log: bool = True, title: str = "PSF",
             save: str | None = None, close: bool = False):
    """PSF / camera frame display, log-stretched by default (the
    reference's imagesc(log10(psf)) idiom in the tutorials)."""
    plt = _mpl()
    im_ = np.asarray(image, dtype=np.float64)
    if log:
        floor = np.max(im_) * 1e-8
        im_ = np.log10(np.maximum(im_, floor))
    fig, ax = plt.subplots(figsize=(4.2, 4))
    h = ax.imshow(im_, origin="lower", cmap="inferno")
    ax.set_title(title + (" (log10)" if log else ""))
    ax.set_xticks([])
    ax.set_yticks([])
    fig.colorbar(h, ax=ax, shrink=0.85)
    return _finish(fig, save, close)


def show_telemetry(outputs, dt: float = 1.0 / 200.0,
                   save: str | None = None, close: bool = False):
    """Closed-loop telemetry traces from a StepOutputs pytree: residual
    vs turbulence RMS, Strehl, and the input-norm trace -- the plots the
    reference builds by hand from its accumulator arrays
    (README.md:604-624)."""
    plt = _mpl()
    rms_res = np.asarray(outputs.rms_res, dtype=np.float64)
    rms_turb = np.asarray(outputs.rms_turb, dtype=np.float64)
    strehl = np.asarray(outputs.strehl_exact, dtype=np.float64)
    u = np.asarray(outputs.u, dtype=np.float64)
    t = np.arange(rms_res.shape[-1]) * dt
    fig, axes = plt.subplots(3, 1, figsize=(6, 7), sharex=True)
    axes[0].plot(t, rms_turb.T, color="0.6", lw=1, label="turbulence")
    axes[0].plot(t, rms_res.T, color="C0", lw=1.2, label="residual")
    axes[0].set_ylabel("RMS [rad]")
    axes[0].legend(loc="upper right", fontsize=8)
    axes[1].plot(t, strehl.T, color="C2", lw=1.2)
    axes[1].set_ylabel("Strehl (exact)")
    axes[1].set_ylim(0, 1.02)
    axes[2].plot(t, np.linalg.norm(u, axis=-1).T, color="C3", lw=1)
    axes[2].set_ylabel("||u|| [rad]")
    axes[2].set_xlabel("time [s]")
    fig.align_ylabels(axes)
    fig.tight_layout()
    return _finish(fig, save, close)


def polar_surface(theta, rho, z, n_grid: int = 128,
                  title: str = "", save: str | None = None,
                  close: bool = False):
    """Surface over scattered polar samples (utilities.polar3,
    utilities.m:427-487): the reference draws a MATLAB polar-axes
    surface; here the samples are interpolated onto a Cartesian grid
    and drawn with the polar frame overlaid."""
    plt = _mpl()
    theta = np.asarray(theta, dtype=np.float64).ravel()
    rho = np.asarray(rho, dtype=np.float64).ravel()
    z = np.asarray(z, dtype=np.float64).ravel()
    x, y = rho * np.cos(theta), rho * np.sin(theta)
    r_max = rho.max() if rho.size else 1.0
    g = np.linspace(-r_max, r_max, n_grid)
    gx, gy = np.meshgrid(g, g)
    # inverse-distance weighting: dependency-free scattered interp,
    # accumulated in grid-row chunks so peak memory stays O(chunk * n)
    # instead of one (n_grid^2, n_samples) matrix (ADVICE r4)
    gxf, gyf = gx.ravel(), gy.ravel()
    num = np.empty(gxf.size)
    den = np.empty(gxf.size)
    chunk = max(1, (1 << 22) // max(x.size, 1))   # ~32 MB f64 per chunk
    for lo in range(0, gxf.size, chunk):
        sl = slice(lo, lo + chunk)
        d2 = ((gxf[sl, None] - x[None, :]) ** 2
              + (gyf[sl, None] - y[None, :]) ** 2)
        w = 1.0 / (d2 + (0.05 * r_max) ** 2)
        num[sl] = w @ z
        den[sl] = w.sum(axis=1)
    zi = (num / den).reshape(n_grid, n_grid)
    zi[np.hypot(gx, gy) > r_max] = np.nan
    fig, ax = plt.subplots(figsize=(4.5, 4))
    im = ax.imshow(zi, origin="lower", extent=(-r_max, r_max,
                                               -r_max, r_max),
                   cmap="viridis")
    circ = plt.Circle((0, 0), r_max, fill=False, color="k", lw=0.8)
    ax.add_patch(circ)
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.85)
    return _finish(fig, save, close)

"""UIB precipitation field plotting (host-side matplotlib).

Counterpart of ``nonstationary_precip_tpu/utils/plotting.py``, on numpy
arrays: each function imports matplotlib (the Agg backend) when it is
called, never at import, so the port imports on a machine without it.
With cartopy importable the map axes get a PlateCarree projection and
gridlines as the reference's (utils/plotting.py:11-37); otherwise plain
lon/lat axes.  Every function returns the figure (for TensorBoard's
``add_figure``) and optionally writes a PNG.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

UIB_EXTENT = (71.0, 83.0, 30.0, 38.0)  # lon_min, lon_max, lat_min, lat_max


def pyplot(what: str):
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib
    does not import (the card's machine), after saying that ``what`` is
    not drawn."""
    try:
        import matplotlib
    except ImportError as e:
        print(f"matplotlib does not import ({e}): {what} is not drawn")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _axes(fig, extent=UIB_EXTENT):
    try:
        import cartopy.crs as ccrs
    except ImportError:
        ax = fig.add_subplot()
        ax.set_xlim(extent[0], extent[1])
        ax.set_ylim(extent[2], extent[3])
        ax.set_xlabel("Longitude")
        ax.set_ylabel("Latitude")
        return ax
    ax = fig.add_subplot(projection=ccrs.PlateCarree())
    ax.set_extent(list(extent))
    gl = ax.gridlines(draw_labels=True)
    gl.top_labels = False
    gl.right_labels = False
    return ax


def simple_plot(lon, lat, values, title: str = "", savepath: Optional[str] = None,
                vmin=None, vmax=None, levels: int = 100):
    """Scatter/tricontour field map over the basin (reference
    ``simple_plot``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(4, 5))
    ax = _axes(fig)
    lon, lat, values = map(np.asarray, (lon, lat, values))
    try:
        g = ax.tricontourf(lon, lat, values, levels=levels, vmin=vmin, vmax=vmax)
    except (ValueError, RuntimeError):  # too few or collinear points to triangulate
        g = ax.scatter(lon, lat, c=values, s=18, vmin=vmin, vmax=vmax)
    fig.colorbar(g, ax=ax, label="")
    ax.set_title(title)
    if savepath:
        fig.savefig(savepath, dpi=150, bbox_inches="tight")
        plt.close(fig)  # saved-to-disk figures must not accumulate in
        # pyplot's manager (plot-interval callbacks leak otherwise); the
        # returned object stays usable for inspection
    return fig


def facetgrid_plot(lon, lat, values_by_month, month_names=None, suptitle: str = "",
                   savepath: Optional[str] = None, vmin=0, vmax=7):
    """Monthly facet maps (reference ``facetgrid_plot`` and the 5-month
    figure in spatio_temporal_exp.py:195-217)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = len(values_by_month)
    if month_names is None:
        month_names = ["jan", "feb", "mar", "apr", "may", "jun"][:k]
    fig, axes = plt.subplots(1, k, figsize=(2 * k, 3), squeeze=False)
    lon, lat = np.asarray(lon), np.asarray(lat)
    g = None
    for i, vals in enumerate(values_by_month):
        ax = axes[0][i]
        g = ax.scatter(lon, lat, c=np.asarray(vals), s=10, vmin=vmin, vmax=vmax)
        ax.set_title(month_names[i])
        ax.set_xticks([])
        ax.set_yticks([])
    fig.suptitle(suptitle)
    cbar_ax = fig.add_axes([0.15, 0.05, 0.65, 0.04])
    fig.colorbar(g, cax=cbar_ax, orientation="horizontal")
    if savepath:
        fig.savefig(savepath, dpi=150, bbox_inches="tight")
        plt.close(fig)  # saved-to-disk figures must not accumulate in
        # pyplot's manager (plot-interval callbacks leak otherwise); the
        # returned object stays usable for inspection
    return fig


def lengthscale_map(lon, lat, ell, dim: int = 1, savepath: Optional[str] = None):
    """Lengthscale-process field map (spatial_exp.py:252-274)."""
    return simple_plot(
        lon, lat, np.asarray(ell)[:, dim], title="Lengthscale process", savepath=savepath
    )


def temporal_series_plot(t, y_obs, f_mean, f_sigma, test_start=None,
                         title: str = "", savepath: Optional[str] = None,
                         test_mean=None):
    """1-D temporal GP fit figure (reference ``temporal_exp.py:130-137``):
    observations as green '+', posterior mean with a ±2σ band, an
    optional red test-region mean and a dashed line at the train/test
    boundary."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t, y_obs, f_mean, f_sigma = map(np.asarray, (t, y_obs, f_mean, f_sigma))
    fig = plt.figure(figsize=(9, 3))
    plt.scatter(t, y_obs, marker="+", c="green", label="Observations")
    plt.plot(t, f_mean, color="orange")
    plt.fill_between(t, f_mean - 2 * f_sigma, f_mean + 2 * f_sigma,
                     color="orange", alpha=0.5)
    if test_start is not None:
        if test_mean is not None:
            plt.plot(t[test_start:], np.asarray(test_mean), color="r",
                     label="Posterior test mean")
        plt.axvline(t[test_start], color="k", linestyle="--")
    plt.legend(fontsize="x-small")
    plt.title(title, fontsize="small")
    if savepath:
        fig.savefig(savepath, dpi=150, bbox_inches="tight")
        plt.close(fig)  # saved-to-disk figures must not accumulate in
        # pyplot's manager (plot-interval callbacks leak otherwise); the
        # returned object stays usable for inspection
    return fig


def etopo_relief_map(lon, lat, values=None, dem=None, title: str = "",
                     savepath: Optional[str] = None, extent=UIB_EXTENT,
                     cmap: str = "gist_earth"):
    """Station values over a hillshaded terrain-relief background — the
    counterpart of the reference's Basemap etopo basin map
    (the reference's utils/plotting.py:64-75, ``plot_uib_etopo_image``).

    Basemap (and its bundled etopo raster) is not in this image and the
    environment has no network, so the elevation model is supplied by the
    caller: ``dem`` is either a mapping with ``elevation`` (H, W),
    ``lon`` (W,), ``lat`` (H,) entries, or a path to an ``.npz`` with
    those keys (e.g. an ETOPO crop the user ships).  When ``dem`` is None
    a repo-local ``data/uib_dem.npz`` is tried; if that's absent too, the
    map degrades to ``simple_plot`` (no relief) rather than fabricating
    terrain.

    Rendering: matplotlib ``LightSource`` shaded relief (az 315, alt 45 —
    the etopo convention) with the station ``values`` scattered on top.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LightSource

    if dem is None:
        from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

        candidate = DATASET_DIR / "uib_dem.npz"
        if candidate.exists():
            dem = str(candidate)
    if dem is None:
        return simple_plot(lon, lat, values, title=title or "UIB basin",
                           savepath=savepath)
    if isinstance(dem, (str, bytes)) or hasattr(dem, "__fspath__"):
        dem = np.load(dem)

    elev = np.asarray(dem["elevation"], dtype=np.float64)
    dlon = np.asarray(dem["lon"], dtype=np.float64)
    dlat = np.asarray(dem["lat"], dtype=np.float64)

    fig = plt.figure(figsize=(5, 5))
    ax = _axes(fig, extent=extent)
    ls = LightSource(azdeg=315, altdeg=45)
    rgb = ls.shade(elev, cmap=plt.get_cmap(cmap), blend_mode="overlay",
                   vert_exag=2.0)
    ax.imshow(
        rgb,
        extent=(dlon.min(), dlon.max(), dlat.min(), dlat.max()),
        origin="lower" if dlat[0] < dlat[-1] else "upper",
        aspect="auto",
        zorder=0,
    )
    if values is not None:
        g = ax.scatter(np.asarray(lon), np.asarray(lat), c=np.asarray(values),
                       s=22, edgecolors="k", linewidths=0.3, zorder=2)
        fig.colorbar(g, ax=ax, label="")
    ax.set_title(title or "UIB basin (relief)")
    if savepath:
        fig.savefig(savepath, dpi=150, bbox_inches="tight")
        plt.close(fig)  # saved-to-disk figures must not accumulate in
        # pyplot's manager (plot-interval callbacks leak otherwise); the
        # returned object stays usable for inspection
    return fig

"""Diagnostic plots: the consensus clustergram and the K-selection figure.

Host-side matplotlib, mirroring the reference's figures (cnmf.py:986-1079,
1137-1158). Within-cluster leaf ordering uses scipy average-linkage on the
already-computed distance matrix. matplotlib is imported by the plotting
functions only, so the pipeline runs without it when no figure is asked
for.
"""

from __future__ import annotations

import numpy as np
from scipy.cluster.hierarchy import leaves_list, linkage
from scipy.spatial.distance import squareform


def cluster_leaf_order(topics_dist: np.ndarray, labels: np.ndarray) -> list:
    """Per-cluster average-linkage leaf ordering of spectra."""
    spectra_order = []
    for cl in sorted(set(labels)):
        cl_filter = labels == cl
        if cl_filter.sum() > 1:
            cl_dist = squareform(
                topics_dist[cl_filter, :][:, cl_filter], checks=False
            )
            cl_dist[cl_dist < 0] = 0
            cl_link = linkage(cl_dist, "average")
            spectra_order += list(np.where(cl_filter)[0][leaves_list(cl_link)])
        else:
            spectra_order += list(np.where(cl_filter)[0])
    return spectra_order


def clustergram(
    topics_dist: np.ndarray,
    labels: np.ndarray,
    local_density: np.ndarray,
    density_threshold: float,
    density_filter: np.ndarray,
    out_png: str,
    close_fig: bool = True,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import gridspec

    spectra_order = cluster_leaf_order(topics_dist, labels)

    width_ratios = [0.5, 9, 0.5, 4, 1]
    height_ratios = [0.5, 9]
    fig = plt.figure(figsize=(sum(width_ratios), sum(height_ratios)))
    gs = gridspec.GridSpec(
        len(height_ratios), len(width_ratios), fig,
        0.01, 0.01, 0.98, 0.98,
        height_ratios=height_ratios, width_ratios=width_ratios,
        wspace=0, hspace=0,
    )

    dist_ax = fig.add_subplot(
        gs[1, 1], xscale="linear", yscale="linear",
        xticks=[], yticks=[], xlabel="", ylabel="", frameon=True,
    )
    D = topics_dist[spectra_order, :][:, spectra_order]
    dist_im = dist_ax.imshow(
        D, interpolation="none", cmap="viridis", aspect="auto", rasterized=True
    )

    left_ax = fig.add_subplot(
        gs[1, 0], xscale="linear", yscale="linear", xticks=[], yticks=[],
        xlabel="", ylabel="", frameon=True,
    )
    left_ax.imshow(
        np.asarray(labels)[spectra_order].reshape(-1, 1),
        interpolation="none", cmap="Spectral", aspect="auto", rasterized=True,
    )

    top_ax = fig.add_subplot(
        gs[0, 1], xscale="linear", yscale="linear", xticks=[], yticks=[],
        xlabel="", ylabel="", frameon=True,
    )
    top_ax.imshow(
        np.asarray(labels)[spectra_order].reshape(1, -1),
        interpolation="none", cmap="Spectral", aspect="auto", rasterized=True,
    )

    hist_gs = gridspec.GridSpecFromSubplotSpec(
        3, 1, subplot_spec=gs[1, 3], wspace=0, hspace=0
    )
    hist_ax = fig.add_subplot(
        hist_gs[0, 0], xscale="linear", yscale="linear",
        xlabel="", ylabel="", frameon=True, title="Local density histogram",
    )
    hist_ax.hist(np.asarray(local_density), bins=np.linspace(0, 1, 50))
    hist_ax.yaxis.tick_right()
    xlim = hist_ax.get_xlim()
    ylim = hist_ax.get_ylim()
    if density_threshold < xlim[1]:
        hist_ax.axvline(density_threshold, linestyle="--", color="k")
        hist_ax.text(
            density_threshold + 0.02, ylim[1] * 0.95,
            "filtering\nthreshold\n\n", va="top",
        )
    hist_ax.set_xlim(xlim)
    density_filter = np.asarray(density_filter)
    hist_ax.set_xlabel(
        "Mean distance to k nearest neighbors\n\n"
        "%d/%d (%.0f%%) spectra above threshold\nwere removed prior to clustering"
        % (
            int((~density_filter).sum()),
            len(density_filter),
            100 * float((~density_filter).mean()),
        )
    )

    cbar_gs = gridspec.GridSpecFromSubplotSpec(
        8, 1, subplot_spec=hist_gs[1, 0], wspace=0, hspace=0
    )
    cbar_ax = fig.add_subplot(
        cbar_gs[4, 0], xscale="linear", yscale="linear",
        xlabel="", ylabel="", frameon=True, title="Euclidean Distance",
    )
    vmin, vmax = float(D.min()), float(D.max())
    fig.colorbar(
        dist_im, cax=cbar_ax,
        ticks=np.linspace(vmin, vmax, 3), orientation="horizontal",
    )

    fig.savefig(out_png, dpi=250)
    if close_fig:
        plt.close(fig)
    return fig


def k_selection_figure(stats, out_png: str, close_fig: bool = True):
    """Stability (silhouette) and error (prediction error) against K, on two
    axes; ``stats`` has columns k, silhouette and prediction_error."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 4))
    ax1 = fig.add_subplot(111)
    ax2 = ax1.twinx()

    ax1.plot(stats.k, stats.silhouette, "o-", color="b")
    ax1.set_ylabel("Stability", color="b", fontsize=15)
    for tl in ax1.get_yticklabels():
        tl.set_color("b")

    ax2.plot(stats.k, stats.prediction_error, "o-", color="r")
    ax2.set_ylabel("Error", color="r", fontsize=15)
    for tl in ax2.get_yticklabels():
        tl.set_color("r")

    ax1.set_xlabel("Number of Components", fontsize=15)
    ax1.grid("on")
    plt.tight_layout()
    fig.savefig(out_png, dpi=250)
    if close_fig:
        plt.close(fig)
    return fig

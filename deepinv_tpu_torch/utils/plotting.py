"""Plotting (port of deepinv_tpu/utils/plotting.py): ``plot``,
``plot_curves``, ``plot_parameters``, ``plot_inset``, ``scatter_plot``, the
video animations and the orthogonal views of a volume.

matplotlib is imported where a figure is made, with the Agg backend. Every
function takes tensors (on any device: they are detached and read to the
host first) or numpy arrays, ``(B, C, H, W)``, and saves or returns the
figure.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["plot", "plot_curves", "plot_parameters", "plot_inset", "scatter_plot", "rescale_img",
           "preprocess_img", "prepare_images", "plot_videos", "save_videos", "plot_ortho3D"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(x):
    """A tensor (detached, read to the host, float32 where it is a narrower
    float) or an array-like, as numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.is_floating_point() and x.element_size() < 4:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _to_np_img(x):
    a = _np(x)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 3:
        if a.shape[0] in (1, 3):
            a = a.transpose(1, 2, 0)
        if a.shape[-1] == 1:
            a = a[..., 0]
    return a


def rescale_img(x, rescale_mode: str = "min_max"):
    """``x`` as float32 in [0, 1]: min-max rescaled, or clipped (plotting.py:38)."""
    a = _np(x).astype(np.float32)
    if rescale_mode == "min_max":
        lo, hi = a.min(), a.max()
        return (a - lo) / max(hi - lo, 1e-9)
    return np.clip(a, 0, 1)


def preprocess_img(im, rescale_mode: str = "min_max", *, vmin=None, vmax=None,
                   return_scale: bool = False):
    """A batch ``(B, C, *)`` in [0, 1] for display (plotting.py:46): complex or
    2-channel (real, imaginary) inputs become their modulus first;
    ``min_max`` rescales each element, ``clip`` clamps to [vmin, vmax].
    ``return_scale`` also returns each element's (min, max) before."""
    a = _np(im)
    if np.iscomplexobj(a) or (a.ndim > 1 and a.shape[1] == 2):
        if np.iscomplexobj(a):
            a = np.abs(a)
        else:
            a = np.sqrt(a[:, :1] ** 2 + a[:, 1:2] ** 2)
    a = a.astype(np.float32)
    axes = tuple(range(1, a.ndim))
    if rescale_mode == "min_max":
        lo = a.min(axis=axes, keepdims=True)
        hi = a.max(axis=axes, keepdims=True)
        out = (a - lo) / np.maximum(hi - lo, 1e-9)
        scales = list(zip(np.ravel(lo).tolist(), np.ravel(hi).tolist()))
    elif rescale_mode == "clip":
        v0 = 0.0 if vmin is None else vmin
        v1 = 1.0 if vmax is None else vmax
        out = np.clip(a, v0, v1)
        scales = [(v0, v1)] * a.shape[0]
    else:
        raise ValueError(f"unknown rescale_mode {rescale_mode!r}")
    return (out, scales) if return_scale else out


def prepare_images(x=None, y=None, x_net=None, x_nl=None,
                   rescale_mode: str = "min_max"):
    """``(images, titles, grid, caption)`` for logging a reconstruction
    (plotting.py:76): the ground truth, the measurement (where it has x's
    shape), the no-learning estimate and the network's output, each through
    :func:`preprocess_img`, and one grid of them all."""
    from . import make_grid

    imgs, titles = [], []
    caption = "From left to right: "
    if x is not None:
        imgs.append(x)
        titles.append("Ground truth")
        caption += "Ground truth, "
    if y is not None and x is not None and tuple(y.shape) == tuple(x.shape):
        imgs.append(y)
        titles.append("Measurement")
        caption += "Measurement, "
    if x_nl is not None:
        imgs.append(x_nl)
        titles.append("No learning")
        caption += "No learning, "
    if x_net is not None:
        imgs.append(x_net)
        titles.append("Reconstruction")
        caption += "Reconstruction"
    vis = [preprocess_img(im, rescale_mode=rescale_mode) for im in imgs]
    grid = (make_grid(np.concatenate(vis), nrow=tuple(imgs[0].shape)[0])
            if vis else None)
    return vis, titles, grid, caption


def plot(img_list, titles=None, save_fn: Optional[str] = None, show: bool = False, figsize=None,
         rescale_mode="min_max", cmap="gray", suptitle=None):
    """A row of images (plotting.py:109)."""
    plt = _mpl()
    if not isinstance(img_list, (list, tuple)):
        img_list = [img_list]
    if titles is None:
        titles = [None] * len(img_list)
    elif isinstance(titles, str):
        titles = [titles]
    n = len(img_list)
    fig, axes = plt.subplots(1, n, figsize=figsize or (3 * n, 3), squeeze=False)
    for ax, img, title in zip(axes[0], img_list, titles):
        ax.imshow(rescale_img(_to_np_img(img), rescale_mode), cmap=cmap)
        ax.axis("off")
        if title:
            ax.set_title(title, fontsize=9)
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    if save_fn:
        fig.savefig(save_fn, bbox_inches="tight", dpi=150)
    if not show:
        plt.close(fig)
    return fig


def plot_curves(metrics: dict, save_fn: Optional[str] = None, show: bool = False):
    """Per-iteration metric curves, one panel a metric (plotting.py:135)."""
    plt = _mpl()
    n = len(metrics)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    for ax, (name, values) in zip(axes[0], metrics.items()):
        vals = _np(values)
        if vals.ndim == 1:
            vals = vals[None]
        for b in range(vals.shape[0]):
            ax.plot(vals[b], label=f"b{b}" if vals.shape[0] > 1 else None)
        ax.set_title(name)
        ax.set_xlabel("iteration")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    if save_fn:
        fig.savefig(save_fn, bbox_inches="tight", dpi=150)
    if not show:
        plt.close(fig)
    return fig


def plot_parameters(model, save_fn: Optional[str] = None, show: bool = False):
    """The per-iteration parameters of an unfolded model (plotting.py:157)."""
    plt = _mpl()
    params = getattr(model, "params_algo", {})
    keys = [k for k, v in params.items() if _np(v).ndim >= 1]
    fig, ax = plt.subplots(figsize=(5, 3))
    for k in keys:
        v = _np(params[k])
        if v.ndim == 1:
            ax.plot(v, marker="o", label=k)
    ax.set_xlabel("iteration")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    if save_fn:
        fig.savefig(save_fn, bbox_inches="tight", dpi=150)
    if not show:
        plt.close(fig)
    return fig


def plot_inset(img_list, titles=None, inset_loc=(0.0, 0.0), inset_size: float = 0.4,
               extract_loc=(0.5, 0.5), extract_size: float = 0.2, save_fn=None, show=False):
    """Images with a zoomed inset (plotting.py:179)."""
    plt = _mpl()
    if not isinstance(img_list, (list, tuple)):
        img_list = [img_list]
    n = len(img_list)
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3), squeeze=False)
    titles = titles or [None] * n
    for ax, img, title in zip(axes[0], img_list, titles):
        a = rescale_img(_to_np_img(img))
        H, W = a.shape[:2]
        ax.imshow(a, cmap="gray")
        ey, ex = int(extract_loc[0] * H), int(extract_loc[1] * W)
        eh, ew = int(extract_size * H), int(extract_size * W)
        patch = a[ey : ey + eh, ex : ex + ew]
        axin = ax.inset_axes([inset_loc[1], inset_loc[0], inset_size, inset_size])
        axin.imshow(patch, cmap="gray")
        axin.set_xticks([])
        axin.set_yticks([])
        for s in axin.spines.values():
            s.set_color("red")
        ax.axis("off")
        if title:
            ax.set_title(title, fontsize=9)
    fig.tight_layout()
    if save_fn:
        fig.savefig(save_fn, bbox_inches="tight", dpi=150)
    if not show:
        plt.close(fig)
    return fig


def scatter_plot(points, labels=None, save_fn=None, show=False):
    """A 2-D scatter plot (plotting.py:211)."""
    plt = _mpl()
    pts = _np(points)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.scatter(pts[:, 0], pts[:, 1], c=labels, s=8, cmap="tab10")
    fig.tight_layout()
    if save_fn:
        fig.savefig(save_fn, bbox_inches="tight", dpi=150)
    if not show:
        plt.close(fig)
    return fig


def plot_videos(vid_list, titles=None, time_dim: int = 2,
                rescale_mode: str = "min_max", display: bool = False,
                figsize=None, save_fn: Optional[str] = None, dpi=None,
                **kwargs):
    """Animate (B, C, T, H, W) videos side by side (plotting.py:225).

    Builds a matplotlib ``FuncAnimation`` over the time axis — one subplot
    per video. ``save_fn`` writes a GIF (Pillow writer); ``display``
    returns HTML in notebooks, otherwise shows the figure.

    :param vid_list: one array or a list of arrays with a time axis at
        ``time_dim``.
    :param titles: per-video subplot titles.
    :return: the animation object.
    """
    plt = _mpl()
    from matplotlib import animation

    if not isinstance(vid_list, (list, tuple)):
        vid_list = [vid_list]
    vids = [np.moveaxis(_np(v), time_dim, 0) for v in vid_list]
    T = min(v.shape[0] for v in vids)
    if isinstance(titles, str):
        titles = [titles]

    fig, axs = plt.subplots(
        1, len(vids), figsize=figsize or (3 * len(vids), 3), dpi=dpi,
        squeeze=False,
    )
    ims = []
    for j, (ax, v) in enumerate(zip(axs[0], vids)):
        frame = rescale_img(_to_np_img(v[0]), rescale_mode)
        ims.append(ax.imshow(frame, cmap="gray" if frame.ndim == 2 else None))
        ax.set_axis_off()
        if titles is not None and j < len(titles):
            ax.set_title(titles[j])

    def update(t):
        for im, v in zip(ims, vids):
            im.set_data(rescale_img(_to_np_img(v[t]), rescale_mode))
        return ims

    anim = animation.FuncAnimation(fig, update, frames=T, interval=100,
                                   blit=False)
    if save_fn is not None:
        if not str(save_fn).endswith((".gif", ".mp4")):
            save_fn = str(save_fn) + ".gif"
        writer = (animation.PillowWriter(fps=10)
                  if str(save_fn).endswith(".gif")
                  else animation.FFMpegWriter(fps=10))
        anim.save(save_fn, writer=writer)
    if display:
        try:  # inline HTML in a notebook
            from IPython.display import HTML

            return HTML(anim.to_jshtml())
        except ImportError:
            plt.show()
    plt.close(fig)
    return anim


def save_videos(vid_list, titles=None, time_dim: int = 2,
                rescale_mode: str = "min_max", figsize=None,
                save_fn: str = "video.gif", **kwargs):
    """Save videos as a GIF (plotting.py:288), through
    :func:`plot_videos`."""
    plot_videos(vid_list, titles=titles, time_dim=time_dim,
                rescale_mode=rescale_mode, figsize=figsize, save_fn=save_fn)
    return save_fn if str(save_fn).endswith((".gif", ".mp4")) else str(save_fn) + ".gif"


def plot_ortho3D(img_list, titles=None, save_fn: Optional[str] = None,
                 rescale_mode: str = "min_max", show: bool = False,
                 figsize=None, return_fig: bool = False, **kwargs):
    """True three-plane orthogonal view of (B, C, D, H, W) volumes
    (plotting.py:298): the central
    axial (D/2), coronal (H/2) and sagittal (W/2) slices arranged in an
    L-shaped layout, one column per volume.
    """
    plt = _mpl()

    if not isinstance(img_list, (list, tuple)):
        img_list = [img_list]
    vols = []
    for v in img_list:
        v = _np(v)
        while v.ndim > 4:  # drop leading batch
            v = v[0]
        if v.ndim == 3:
            v = v[None]
        vols.append(v)  # (C, D, H, W)
    if isinstance(titles, str):
        titles = [titles]

    n = len(vols)
    fig, axs = plt.subplots(2, 2 * n, figsize=figsize or (4 * n, 4),
                            squeeze=False)
    for j, v in enumerate(vols):
        C, D, H, W = v.shape
        axial = v[:, D // 2]              # (C, H, W)
        coronal = v[:, :, H // 2]         # (C, D, W)
        sagittal = v[:, :, :, W // 2]     # (C, D, H)
        panes = [
            (axs[0][2 * j], axial, "axial"),
            (axs[1][2 * j], coronal, "coronal"),
            (axs[0][2 * j + 1], np.swapaxes(sagittal, -1, -2), "sagittal"),
        ]
        for ax, sl, name in panes:
            img = rescale_img(_to_np_img(sl), rescale_mode)
            ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
            ax.set_axis_off()
        axs[1][2 * j + 1].set_axis_off()
        if titles is not None and j < len(titles):
            axs[0][2 * j].set_title(titles[j])

    fig.tight_layout()
    if save_fn is not None:
        fig.savefig(save_fn, bbox_inches="tight")
    if show:
        plt.show()
    if return_fig:
        return fig
    plt.close(fig)

"""Interactive volume scroll-viewer (j/k keys step through slices); the
counterpart of gnn_tumor_seg_tpu/viz/volume_viewer.py.

Capability match for `visualization/VolumeViewingTool.py:7-56`. matplotlib
is imported inside the functions that draw.
"""

from __future__ import annotations

__all__ = ["multi_slice_viewer"]


def _remove_keymap_conflicts(new_keys):
    import matplotlib.pyplot as plt

    for prop in plt.rcParams:
        if prop.startswith("keymap."):
            keys = plt.rcParams[prop]
            for k in set(keys) & new_keys:
                keys.remove(k)


def multi_slice_viewer(to_display, show: bool = True):
    """to_display: list of dicts {'arr', 'cmap', 'stride', 'title'}; arranges
    panels on a 2-row grid; j/k scroll all panels through the z axis."""
    import matplotlib.pyplot as plt

    _remove_keymap_conflicts({"j", "k"})
    n = len(to_display)
    ncols = (n + 1) // 2
    fig, axs = plt.subplots(2, max(ncols, 1), squeeze=False)
    flat_axes = [axs[i % 2][i // 2] for i in range(2 * max(ncols, 1))]
    for ax, spec in zip(flat_axes, to_display):
        arr = spec["arr"]
        ax.volume = arr
        ax.index = arr.shape[2] // 2
        ax.stride = spec.get("stride", 1)
        ax.cmap = spec.get("cmap", "gray")
        ax.imshow(arr[:, :, ax.index], cmap=ax.cmap)
        ax.set_title(spec.get("title", ""))
        ax.axis("off")
    for ax in flat_axes[n:]:
        ax.axis("off")
    fig.canvas.mpl_connect("key_press_event", _process_key)
    if show:
        plt.show()
    return fig


def _process_key(event):
    fig = event.canvas.figure
    for ax in fig.axes:
        if not hasattr(ax, "volume"):
            continue
        if event.key == "j":
            _step_slice(ax, -ax.stride)
        elif event.key == "k":
            _step_slice(ax, ax.stride)
    fig.canvas.draw()


def _step_slice(ax, delta):
    vol = ax.volume
    ax.index = (ax.index + delta) % vol.shape[2]
    ax.images[0].set_array(vol[:, :, ax.index])

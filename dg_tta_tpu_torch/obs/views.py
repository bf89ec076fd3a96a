"""Volume orientation views (the port of `dg_tta_tpu/obs/views.py`; the
reference's ipynb_utils.py:53-151): 3-plane x 4-slice grids of a volume
for checking a dataset's orientation, and the TS104 reference view to
compare it with."""

from pathlib import Path

import numpy as np


def plane_grid(vol, n_slices: int = 4):
    """Slice indices per axis, evenly spread: {axis: [i0 .. i_{n-1}]}."""
    vol = np.asarray(vol)
    return {ax: np.linspace(0, vol.shape[ax] - 1, n_slices).astype(int)
            for ax in range(3)}


def show_planes(vol, title: str = "", n_slices: int = 4, save_path=None):
    """A 3 x n_slices grid of orthogonal slices of a (D, H, W) volume;
    written to `save_path` when given.  Returns the figure."""
    import matplotlib
    if save_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vol = np.asarray(vol)
    if vol.ndim != 3:
        raise ValueError(f"show_planes needs a 3-D volume, got shape "
                         f"{vol.shape}")
    fig, axes = plt.subplots(3, n_slices, figsize=(3 * n_slices, 9))
    for row, (ax_idx, idxs) in enumerate(plane_grid(vol, n_slices).items()):
        for col, i in enumerate(idxs):
            sl = np.take(vol, i, axis=ax_idx)
            axes[row, col].imshow(sl, cmap="gray")
            axes[row, col].set_title(f"axis{ax_idx}[{i}]")
            axes[row, col].axis("off")
    fig.suptitle(title)
    if save_path is not None:
        fig.savefig(save_path)
        plt.close(fig)
    return fig


def show_image_file(path, **kw):
    """`show_planes` of the first channel of an image file
    (`data/io.read_image`), titled with its name and spacing."""
    from dg_tta_tpu_torch.data.io import read_image
    data, props = read_image(path)
    return show_planes(data[0], title=f"{Path(path).name} "
                                      f"spacing={props['spacing']}", **kw)


def show_ts104_reference_image(save_path=None):
    """The TS104 canonical-orientation screenshot (the reference's
    ipynb_utils.py:141-151 `show_ts104_image`), to compare a dataset's
    orientation with.  It ships with the upstream resources, not with this
    package: place it at `resources.RESOURCES / "TS104_input_view.png"`.
    Raises FileNotFoundError naming that path where it is absent.
    Returns the figure."""
    from dg_tta_tpu_torch import resources
    img_path = Path(resources.RESOURCES) / "TS104_input_view.png"
    if not img_path.is_file():
        raise FileNotFoundError(
            f"TS104 reference view not found at {img_path}; copy "
            "TS104_input_view.png from the upstream DG-TTA resources there")
    import matplotlib
    if save_path is not None:
        matplotlib.use("Agg")
    import matplotlib.image
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(dpi=150.0, figsize=(7.0, 7.0))
    fig.set_facecolor("black")
    ax.imshow(matplotlib.image.imread(img_path))
    ax.axis("off")
    ax.set_facecolor("black")
    if save_path is not None:
        fig.savefig(save_path, facecolor="black")
        plt.close(fig)
    return fig

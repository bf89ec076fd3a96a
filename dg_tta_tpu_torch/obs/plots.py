"""The per-(sample, member) loss and pseudo-Dice plot (the port of
`dg_tta_tpu/obs/plots.py`; config_log_utils.py:416-452 of the
reference).  matplotlib is imported inside the functions: the driver
skips the plot, with one line, where it cannot be imported
(`matplotlib_available`), and the numbers stay in the run's
`*_tta_results.json` files."""

from pathlib import Path

import numpy as np


def matplotlib_available() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _colormap():
    import matplotlib.colors
    # the reference's four brand colors (config_log_utils.py:416-423)
    return matplotlib.colors.LinearSegmentedColormap.from_list(
        "", ["#e7475e", "#f0d879", "#79DCF0", "#248888"])


def plot_run_results(save_path, sample_id, ensemble_idx, tta_losses,
                     eval_dices):
    """Dual-axis loss / pseudo-Dice PNG of one (sample, member):
    `{sample}__ensemble_idx_{m}_tta_results.png` in `save_path`.  Returns
    its path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.ticker

    tta_losses = np.asarray(tta_losses, dtype=float)
    eval_dices = np.asarray(eval_dices, dtype=float)

    fig, ax_one = plt.subplots()
    ax_two = ax_one.twinx()
    cmap = _colormap()
    c1, c2 = cmap(0.0), cmap(0.8)
    ax_one.plot(tta_losses, label="loss", c=c1)
    ax_one.set_yticks([np.nanmin(tta_losses), np.nanmax(tta_losses)])
    ax_one.set_xlim(0, max(1, len(tta_losses) - 1))
    ax_one.set_ylabel("Soft-Dice Loss", c=c1)
    ax_one.tick_params(axis="y", colors=c1)
    ax_one.set_xlabel("TTA Epoch")
    ax_one.grid(axis="y", linestyle="--", linewidth=0.5)
    ax_one.yaxis.set_major_formatter(
        matplotlib.ticker.FormatStrFormatter("%.3f"))

    if np.isfinite(eval_dices).any():
        ax_two.plot(eval_dices * 100, label="eval_dices", c=c2)
        ax_two.set_yticks([np.nanmin(eval_dices) * 100,
                           np.nanmax(eval_dices) * 100])
        ax_two.set_ylabel("Pseudo-Dice in %", c=c2)
        ax_two.tick_params(axis="y", colors=c2)
        ax_two.yaxis.set_major_formatter(
            matplotlib.ticker.FormatStrFormatter("%.1f"))

    fig.suptitle(f"{sample_id} (ensemble_idx={ensemble_idx})")
    split_sample_id = str(sample_id).split("/")[-1]
    out = Path(save_path) / \
        f"{split_sample_id}__ensemble_idx_{ensemble_idx}_tta_results.png"
    fig.savefig(out)
    fig.tight_layout()
    plt.close(fig)
    return out

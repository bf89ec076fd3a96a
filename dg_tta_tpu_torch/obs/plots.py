"""The JAX package's per-(sample, member) loss and pseudo-Dice plot
(`dg_tta_tpu/obs/plots.py`) needs matplotlib, which the GPU machine lacks:
it comes with a later slice (ROADMAP A.6).  The driver writes the numbers
it would plot to `{id}__ensemble_idx_{m}_tta_results.json` instead."""


def plot_run_results(save_path, sample_id, ensemble_idx, tta_losses,
                     eval_dices):
    raise NotImplementedError("the loss plots are not ported to "
                              "dg_tta_tpu_torch yet (ROADMAP A.6); the "
                              "losses and Dices are in the run's "
                              "*_tta_results.json files")

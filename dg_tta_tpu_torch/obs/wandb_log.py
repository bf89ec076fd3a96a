"""Optional wandb logging (the port of `dg_tta_tpu/obs/wandb_log.py`),
guarded as in the reference (config_log_utils.py:73-84, 397-402): every
call is a no-op unless wandb can be imported and a run is active and not
disabled."""

import importlib.util


def wandb_module():
    if importlib.util.find_spec("wandb") is None:
        return None
    import wandb
    return wandb


def wandb_run_is_available() -> bool:
    wandb = wandb_module()
    return (wandb is not None and wandb.run is not None
            and not wandb.run.disabled)


def wandb_log(data: dict, step=None):
    if wandb_run_is_available():
        wandb_module().log(data, step=step)


def wandb_run(project_name: str, fn, **kwargs):
    """fn(**kwargs) inside a wandb run of the plan's `wandb_mode` when
    wandb can be imported and the mode is not "disabled"; else fn
    called directly."""
    wandb = wandb_module()
    config = kwargs.get("plan")
    mode = getattr(config, "wandb_mode", "disabled")
    if wandb is None or mode == "disabled":
        return fn(**kwargs)
    with wandb.init(project=project_name, name=kwargs.get("run_name"),
                    mode=mode,
                    config=config.to_dict() if config else None):
        out = fn(**kwargs)
    wandb.finish()
    return out

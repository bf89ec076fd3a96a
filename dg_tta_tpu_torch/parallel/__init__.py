"""Several processes, one device each: ensemble members one per GPU,
window-sharded inference and data-parallel pretraining (the port of
`dg_tta_tpu/parallel/`).  `mesh.py` starts the ranks and holds the
collectives, `tta.py` spreads adaptation runs over them, `dryrun.py`
checks every sharded path against its one-rank run."""

"""The `dgtta` command line of the PyTorch port:
`python -m dg_tta_tpu_torch {inject_trainers,pretrain,prepare_tta,run_tta}
...`.

The same arguments as `dg_tta_tpu`'s `dgtta`, plus `--device` on
`pretrain` and `run_tta` (default `cuda`), and `--backend` on both and
`--num_devices` on `run_tta` for runs over several processes
(`parallel/`).  `inject_trainers` injects
nothing: the DG trainers are a built-in registry
(`models/network.TRAINER_REGISTRY`), which it lists.
"""

import argparse
import json
import secrets
import sys
import time


def _cmd_inject_trainers(args):
    from dg_tta_tpu_torch.models.network import TRAINER_REGISTRY
    print("Nothing to inject: DG trainers are a built-in registry "
          "(no nnUNet package patching needed).")
    print("Available trainers:")
    for name in TRAINER_REGISTRY:
        print(f"  {name}")
    if args.num_epochs is not None:
        print(f"(pretraining epochs are passed at `pretrain` time; "
              f"requested default {args.num_epochs})")
    return list(TRAINER_REGISTRY)


def _cmd_pretrain(args):
    from dg_tta_tpu_torch.train.pretrain import run_pretraining
    return run_pretraining(
        dataset_id=args.dataset_id,
        configuration=args.configuration,
        fold=args.fold,
        trainer_name=args.trainer,
        num_epochs=args.num_epochs,
        val_iters_per_epoch=args.val_iters_per_epoch,
        num_devices=args.num_devices,
        plans_name=args.plans_name,
        continue_training=args.continue_training,
        device=args.device,
        backend=args.backend,
    )


def _cmd_prepare_tta(args):
    from dg_tta_tpu_torch.tta.config import prepare_tta
    from dg_tta_tpu_torch.utils.paths import check_dga_root_is_set
    check_dga_root_is_set()
    return prepare_tta(
        pretrained_dataset_id=args.pretrained_dataset_id,
        tta_dataset_id=args.tta_dataset_id,
        pretrainer=args.pretrainer,
        pretrainer_config=args.pretrainer_config,
        pretrainer_fold=args.pretrainer_fold,
        tta_dataset_bucket=args.tta_dataset_bucket,
    )


def _cmd_run_tta(args):
    from dg_tta_tpu_torch.core.labels import generate_label_mapping
    from dg_tta_tpu_torch.tta.config import (
        check_dataset_pretrain_config,
        get_tta_folders,
        load_current_modifier_functions,
    )
    from dg_tta_tpu_torch.obs.wandb_log import wandb_run
    from dg_tta_tpu_torch.tta.driver import tta_main
    from dg_tta_tpu_torch.tta.plan import TTAPlan
    from dg_tta_tpu_torch.utils.device import resolve_device
    from dg_tta_tpu_torch.utils.paths import check_dga_root_is_set

    device = resolve_device(args.device)
    check_dga_root_is_set()
    (pre_id, pretrainer, pretrainer_config, pretrainer_fold) = \
        check_dataset_pretrain_config(args.pretrained_dataset_id,
                                      args.pretrainer, args.pretrainer_config,
                                      args.pretrainer_fold)
    (tta_data_dir, plan_dir, results_dir, pre_name, tta_name) = \
        get_tta_folders(pre_id, args.tta_dataset_id, pretrainer,
                        pretrainer_config, pretrainer_fold)

    plan_path = plan_dir / "tta_plan.json"
    if not plan_path.is_file():
        sys.exit(f"No tta_plan.json in {plan_dir}. Run `prepare_tta` first.")
    plan = TTAPlan.load(plan_path)

    with open(plan_dir / f"{pre_name}_label_mapping.json") as f:
        pre_classes = json.load(f)
    with open(plan_dir / f"{tta_name}_label_mapping.json") as f:
        tta_classes = json.load(f)
    label_mapping = generate_label_mapping(pre_classes, tta_classes)

    modifier_mod = load_current_modifier_functions(plan_dir)

    # {timestamp}_{nonce}-{run_no}; --run_no resumes an existing run
    run_no = args.run_no
    if run_no is None:
        run_name = (time.strftime("%Y%m%d__%H_%M_%S") +
                    f"_{secrets.token_hex(3)}-000")
    else:
        matches = [p for p in sorted(results_dir.glob("*-???"))
                   if p.name.endswith(f"-{run_no:03d}")]
        if not matches:
            sys.exit(f"No existing run with number {run_no} in {results_dir}")
        run_name = matches[-1].name

    # inside a wandb run of the plan's wandb_mode where wandb is installed
    return wandb_run(
        "dg_tta", lambda run_name, plan, **kw: tta_main(run_name, plan, **kw),
        run_name=run_name, plan=plan, tta_data_dir=tta_data_dir,
        save_base_path=results_dir, label_mapping=label_mapping,
        modifier_fn_module=modifier_mod, device=device,
        num_devices=args.num_devices, backend=args.backend)


BACKEND_HELP = ("torch.distributed backend of a run over several processes "
                "(default nccl on cuda, gloo on cpu; gloo lets the "
                "processes share one GPU)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dgtta-torch",
        description=("DG-TTA in PyTorch on NVIDIA GPUs: domain-generalized "
                     "pretraining, test-time adaptation and ensemble "
                     "inference for 3D medical segmentation."))
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("inject_trainers",
                       help="No-op compatibility command (the trainer "
                            "registry is built in)")
    p.add_argument("--num_epochs", type=int, default=None)
    p.set_defaults(fn=_cmd_inject_trainers)

    p = sub.add_parser("pretrain", help="Run DG pretraining")
    p.add_argument("dataset_id", help="nnUNet dataset id or name")
    p.add_argument("configuration", nargs="?", default="3d_fullres")
    p.add_argument("fold", nargs="?", default="0")
    p.add_argument("-tr", "--trainer", default="nnUNetTrainer_GIN")
    p.add_argument("--num_epochs", type=int, default=1000)
    p.add_argument("--val_iters_per_epoch", type=int, default=50,
                   help="Validation iterations per epoch (nnUNet default 50)")
    p.add_argument("--num_devices", "-num_gpus", type=int, default=1,
                   help="Data-parallel devices, one process each (the nnUNet "
                        "-num_gpus analog); must divide the batch size")
    p.add_argument("-p", "--plans_name", default="nnUNetPlans",
                   help="Plans identifier (nnUNet's -p)")
    p.add_argument("--c", dest="continue_training", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for the "
                        "plain versions of the kernels)")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help=BACKEND_HELP)
    p.set_defaults(fn=_cmd_pretrain)

    p = sub.add_parser("prepare_tta", help="Prepare plan dir for TTA")
    p.add_argument("pretrained_dataset_id",
                   help="TS104_* alias or numeric dataset id")
    p.add_argument("tta_dataset_id", help="Target dataset id")
    p.add_argument("--pretrainer", default=None)
    p.add_argument("--pretrainer_config", default=None)
    p.add_argument("--pretrainer_fold", default=None)
    p.add_argument("--tta_dataset_bucket", default="imagesTs",
                   choices=["imagesTr", "imagesTs", "imagesTrAndTs"])
    p.set_defaults(fn=_cmd_prepare_tta)

    p = sub.add_parser("run_tta", help="Run test-time adaptation")
    p.add_argument("pretrained_dataset_id")
    p.add_argument("tta_dataset_id")
    p.add_argument("--pretrainer", default=None)
    p.add_argument("--pretrainer_config", default=None)
    p.add_argument("--pretrainer_fold", default=None)
    p.add_argument("--run_no", type=int, default=None,
                   help="Resume an existing run number")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for the "
                        "plain versions of the kernels)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="Devices to spread the ensemble members over, one "
                        "process each (default: every visible GPU; "
                        "CUDA_VISIBLE_DEVICES restricts them; 1 with "
                        "--device cpu)")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help=BACKEND_HELP)
    p.set_defaults(fn=_cmd_run_tta)
    return parser


def main(argv=None):
    """Parse `argv` and run the subcommand; returns its result
    (`run_tta`: the evaluation summaries by bucket; `pretrain`: the fold's
    results directory; `inject_trainers`: the trainer names)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)

"""The `dgtta` command line of the PyTorch port:
`python -m dg_tta_tpu_torch {prepare_tta,run_tta} ...`.

The same arguments as `dg_tta_tpu`'s `dgtta`, plus `run_tta --device`
(default `cuda`).  `pretrain` and `inject_trainers` belong to later slices.
"""

import argparse
import json
import secrets
import sys
import time


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

    return tta_main(run_name, plan, tta_data_dir=tta_data_dir,
                    save_base_path=results_dir, label_mapping=label_mapping,
                    modifier_fn_module=modifier_mod, device=device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dgtta-torch",
        description=("DG-TTA in PyTorch on NVIDIA GPUs: test-time adaptation "
                     "and ensemble inference for 3D medical segmentation."))
    sub = parser.add_subparsers(dest="command", required=True)

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
    p.set_defaults(fn=_cmd_run_tta)
    return parser


def main(argv=None):
    """Parse `argv` and run the subcommand; returns its result
    (`run_tta`: the evaluation summaries by bucket)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)

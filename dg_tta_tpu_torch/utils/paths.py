"""Environment-variable path plumbing.

Same contract as the reference (upstream DG-TTA dg_tta/utils.py and README
env table): `DG_TTA_ROOT` is the work root; `nnUNet_raw` / `nnUNet_results`
locate datasets and pretraining results in nnUNet's folder schema.  (The
internal-augmentation env toggle is gone — that behavior is an explicit
argument of Model.apply here.)
"""

import os
import re
from pathlib import Path


def dg_tta_root() -> Path:
    check_dga_root_is_set()
    return Path(os.environ["DG_TTA_ROOT"])


def nnunet_raw() -> Path:
    return Path(os.environ["nnUNet_raw"])


def nnunet_results() -> Path:
    return Path(os.environ["nnUNet_results"])


def check_dga_root_is_set(soft_check: bool = False) -> bool:
    is_set = os.environ.get("DG_TTA_ROOT") is not None and \
        Path(os.environ["DG_TTA_ROOT"]).is_dir()
    if soft_check:
        return is_set
    assert is_set, (
        "Please set the DG_TTA_ROOT environment variable to an existing "
        "directory (e.g. export DG_TTA_ROOT=$(pwd)/dg_tta_root)")
    return True


def set_environ_vars_from_paths_sh(paths_sh: str):
    """Parse `export VAR=value` lines from a paths.sh file (utils.py:33-40)."""
    text = Path(paths_sh).read_text()
    for m in re.finditer(r"^\s*export\s+(\w+)=[\"']?([^\"'\n]+)[\"']?",
                         text, re.MULTILINE):
        os.environ[m.group(1)] = m.group(2)


def maybe_convert_to_dataset_name(dataset_id) -> str:
    """Resolve an integer id to the `Dataset{id:03d}_*` folder under
    nnUNet_raw (nnUNet's maybe_convert_to_dataset_name contract)."""
    if isinstance(dataset_id, str) and not dataset_id.isnumeric():
        return dataset_id
    did = int(dataset_id)
    prefix = f"Dataset{did:03d}_"
    candidates = [p.name for p in nnunet_raw().iterdir()
                  if p.is_dir() and p.name.startswith(prefix)]
    if not candidates:
        raise FileNotFoundError(
            f"No dataset folder {prefix}* under {nnunet_raw()}")
    assert len(candidates) == 1, f"Ambiguous dataset id {did}: {candidates}"
    return candidates[0]

"""The PyTorch port stands alone: neither `dg_tta_tpu_torch` nor
chip_smoke.py imports JAX or the JAX package, and a CUDA request on a
machine without a GPU raises instead of running on the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "dg_tta_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|dg_tta_tpu)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|dg_tta_tpu)\b(?!_torch))", re.MULTILINE)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 20
    offenders = []
    for path in PORT_FILES:
        for m in FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_the_parallel_package_is_among_the_checked_files():
    """`parallel/` (the several-process paths, whose ranks import it in
    fresh processes) is held to the same rule as the rest."""
    parallel = {p.name for p in PORT_FILES if p.parent.name == "parallel"}
    assert {"__init__.py", "mesh.py", "tta.py", "dryrun.py"} <= parallel


def test_forbidden_pattern_catches_what_it_should():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from dg_tta_tpu.models import unet")
    assert FORBIDDEN.search("import dg_tta_tpu")
    assert not FORBIDDEN.search("from dg_tta_tpu_torch.models import unet")
    assert not FORBIDDEN.search("import dg_tta_tpu_torch.cli")


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "dg_tta_tpu_torch").rglob("*.py")
        if p.name != "__main__.py")
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith(('jax.', 'jaxlib', 'dg_tta_tpu.')) "
            "or k == 'dg_tta_tpu')\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")


def test_cuda_request_without_gpu_raises(no_cuda):
    from dg_tta_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_network_defaults_to_cuda(no_cuda):
    from dg_tta_tpu_torch.models.network import build_model

    plans = {"configurations": {"3d_fullres": {
        "patch_size": [8, 8, 8], "UNet_base_num_features": 4,
        "unet_max_num_features": 8, "n_conv_per_stage_encoder": [1, 1],
        "n_conv_per_stage_decoder": [1],
        "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2]],
        "conv_kernel_sizes": [[3, 3, 3], [3, 3, 3]]}}}
    model = build_model(plans, {"labels": {"background": 0, "a": 1}},
                        "nnUNetTrainer")
    with pytest.raises(RuntimeError, match="cuda"):
        model.build_network()
    net = model.build_network(device="cpu")
    assert next(net.parameters()).device == torch.device("cpu")


def test_run_tta_on_cuda_without_gpu_raises(no_cuda, tmp_path, monkeypatch):
    from dg_tta_tpu_torch.cli.main import main
    from dg_tta_tpu_torch.tta.driver import tta_main
    from dg_tta_tpu_torch.tta.plan import TTAPlan

    monkeypatch.setenv("DG_TTA_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["run_tta", "TS104_GIN", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        tta_main("run", TTAPlan(optimized_labels=("background",)), tmp_path,
                 tmp_path, {"background": (0, 0)}, device="cuda")


def test_kernel_wrapper_refuses_non_cuda_devices():
    from dg_tta_tpu_torch.kernels.conv3x3 import conv3x3

    x = torch.zeros(2, 4, 4, 3, device="meta")
    w = torch.zeros(3, 3, 3, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3(x, w)


def test_pretraining_on_cuda_without_gpu_raises(no_cuda, tmp_path,
                                                monkeypatch):
    """`run_pretraining` and the CLI's `pretrain` default to CUDA, and
    refuse it before they read a dataset."""
    from dg_tta_tpu_torch.cli.main import main
    from dg_tta_tpu_torch.train.pretrain import run_pretraining

    monkeypatch.setenv("nnUNet_raw", str(tmp_path))
    monkeypatch.setenv("nnUNet_results", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        run_pretraining("Dataset999_None")
    with pytest.raises(RuntimeError, match="cuda"):
        run_pretraining("Dataset999_None", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["pretrain", "Dataset999_None"])


def test_train_modules_import_no_jax():
    """The pretraining package is among the port's sources the checks
    above read, and imports alone."""
    train = {p.name for p in PORT_FILES if p.parent.name == "train"}
    assert {"augment.py", "dataset.py", "losses.py",
            "pretrain.py"} <= train
    code = ("import sys\n"
            "import dg_tta_tpu_torch.train.pretrain\n"
            "import dg_tta_tpu_torch.obs.profile_pretrain\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith(('jax.', 'jaxlib', 'dg_tta_tpu.')) "
            "or k == 'dg_tta_tpu')\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr

"""Device selection: CUDA unless the caller asks for the CPU."""

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means `"cuda"`.  A CUDA device on a machine without a GPU
    raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev

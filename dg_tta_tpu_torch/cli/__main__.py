"""`python -m dg_tta_tpu_torch.cli` entry point (the same surface as
`python -m dg_tta_tpu_torch` and the `dgtta` commands:
`dg_tta_tpu_torch/cli/main.py`)."""
from dg_tta_tpu_torch.cli.main import main

if __name__ == "__main__":
    main()

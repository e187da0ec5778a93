"""``python -m repro_torch.analysis --check [--layers ast,runtime]
[--ranks 1,8] [--device cpu|cuda]``: see :mod:`repro_torch.analysis.cli`."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

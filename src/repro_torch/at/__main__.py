"""``python -m repro_torch.at`` — see :mod:`repro_torch.at.cli`."""
import sys

from .cli import main

if __name__ == "__main__":      # the port's tests import every module
    sys.exit(main())

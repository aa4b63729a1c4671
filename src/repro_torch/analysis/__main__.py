"""``python -m repro_torch.analysis``: the check CLI."""
import sys

from .check import main

sys.exit(main())

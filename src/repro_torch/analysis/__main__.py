"""CLI entry point: ``python -m repro_torch.analysis src/repro_torch``."""
import sys

from repro_torch.analysis.runner import main

if __name__ == "__main__":
    sys.exit(main())

"""``python -m haploconduct_torch`` — the port's CLI entry point."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

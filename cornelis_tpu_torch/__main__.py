"""`python -m cornelis_tpu_torch`: the command line of cli.py."""

import sys

from .cli import main

__all__ = ["main"]

if __name__ == "__main__":
    sys.exit(main())

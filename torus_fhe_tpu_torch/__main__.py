"""``python -m torus_fhe_tpu_torch``: the file-based CLI (cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

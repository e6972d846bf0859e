"""`python -m jxl_oxide_tpu_torch decode x.jxl -o x.png`: the port's CLI
(cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

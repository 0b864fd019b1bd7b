"""`python -m basis_universal_tpu_torch`: the port's command-line tool
(`cli.main`), the counterpart of `python -m basis_universal_tpu`."""
from .cli import main

if __name__ == "__main__":
    import sys

    sys.exit(main())

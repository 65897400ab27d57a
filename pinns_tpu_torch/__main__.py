"""``python -m pinns_tpu_torch`` runs the port CLI."""

import sys

from pinns_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())

"""``python -m bluefog_tpu_torch.profiling``: the profile report CLI."""

import sys

from bluefog_tpu_torch.profiling.cli import main

if __name__ == "__main__":
    sys.exit(main())

"""``ibfrun``: an interactive session with the framework brought up.

Run ``python -m bluefog_tpu_torch.runtime.ibfrun [--simulate N]
[--topology exp2|ring|grid|star|full]``; see
:func:`bluefog_tpu_torch.runtime.launch.interactive_main`."""

import sys

from bluefog_tpu_torch.runtime.launch import interactive_main

if __name__ == "__main__":
    sys.exit(interactive_main())

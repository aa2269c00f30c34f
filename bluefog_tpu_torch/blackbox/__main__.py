"""``python -m bluefog_tpu_torch.blackbox``: the merge/diagnosis CLI (the
JAX package's ``bfblackbox-tpu``)."""

from bluefog_tpu_torch.blackbox.merge import main

raise SystemExit(main())

"""``python -m bluefog_tpu_torch.tracing DIR``: the trace analyzer."""

from bluefog_tpu_torch.tracing.analyze import main

raise SystemExit(main())

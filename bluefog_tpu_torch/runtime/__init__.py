"""The host runtime: the ``bfrun`` launcher and cluster bring-up
(:mod:`.launch`), the native library of ``csrc/*.cc`` with its engine
(:mod:`.native`), and the asynchronous windows and runners
(:mod:`.async_windows`).  Nothing is imported here, so ``python -m
bluefog_tpu_torch.runtime.launch`` loads only the launcher."""

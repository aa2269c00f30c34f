"""The host runtime: the ``bfrun`` launcher and cluster bring-up."""

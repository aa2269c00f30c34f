"""``python -m bluefog_tpu_torch.chaos``: run a command under a chaos spec."""

from bluefog_tpu_torch.chaos.cli import main

if __name__ == "__main__":
    raise SystemExit(main())

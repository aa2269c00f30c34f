from bluefog_tpu_torch.relay.cli import main

if __name__ == "__main__":
    raise SystemExit(main())

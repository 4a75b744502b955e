"""``python -m veles_tpu_torch.forge <cmd> ...``: the forge client CLI."""

from veles_tpu_torch.forge.client import main

if __name__ == "__main__":
    raise SystemExit(main())

"""CLI: python -m hotrack_tpu_torch.train --config <name>.yml [--device cpu]
[--epochs N] [--key/subkey value]."""

from .cli import train_main

if __name__ == "__main__":
    train_main()

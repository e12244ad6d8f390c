"""CLI: python -m hotrack_tpu_torch.test --config <name>.yml [--device cpu] [--save]."""

from hotrack_tpu_torch.train.cli import test_main

if __name__ == "__main__":
    test_main()

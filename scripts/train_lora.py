"""End-to-end LoRA fine-tune driver: latent shards -> adapter safetensors.

Thin wrapper over ltx_jax.train.cli (the same loop the `ltx-video train`
subcommand runs). Kept as a standalone script for environments that drive
training without installing the CLI entry point.

Example:
    python scripts/train_lora.py --data shards/ --out adapter.safetensors \
        --weights ~/.cache/ltx/ltx-2-19b-distilled.safetensors \
        --quant w8a8 --rank 16 --steps 2000 --ckpt run1.npz --ckpt-every 200
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ltx_jax.train.cli import add_train_arguments, run  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_train_arguments(ap)
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()

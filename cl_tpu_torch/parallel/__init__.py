"""Parallelism beyond data parallelism: the height-sharded UNet forward."""

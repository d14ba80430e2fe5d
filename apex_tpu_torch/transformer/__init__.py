"""Megatron-style transformer building blocks (world size 1 in this
slice)."""

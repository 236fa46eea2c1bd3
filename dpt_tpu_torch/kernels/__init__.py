"""Kernels written by hand for the card, with their plain PyTorch versions."""

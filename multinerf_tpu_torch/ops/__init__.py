"""Tensor ops: plain PyTorch functions."""

"""PyTorch + CUDA port of multinerf_tpu for NVIDIA Hopper GPUs.

The package mirrors the JAX package module for module and never imports
jax; see README.md ("PyTorch port on the H100").
"""

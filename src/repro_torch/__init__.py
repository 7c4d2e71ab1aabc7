"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A standalone package beside the JAX reference: it imports torch, numpy
and the standard library, never ``jax`` and nothing of ``repro``.  Its
layout mirrors the reference (configs, core, sparse, kernels, models,
serving, launch); ``csrc/`` holds the hand-written CUDA kernels and
``bridge`` carries reference params across for the parity tests.
"""

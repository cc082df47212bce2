"""PyTorch/CUDA port of the DAG-AFL reproduction (``repro``).

The port mirrors the JAX package module for module and never imports it
(nor ``jax``): the JAX package is the reference the port is tested against.
Model trees are nested dicts/lists of tensors, devices are explicit, and
random draws come from explicit ``torch.Generator`` objects or seeded numpy
generators.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; see :mod:`repro_torch.runtime`.
"""

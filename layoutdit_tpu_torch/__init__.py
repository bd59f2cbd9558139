"""PyTorch/CUDA port of layoutdit_tpu for NVIDIA Hopper (H100).

The JAX package ``layoutdit_tpu`` stays the reference; this package
computes the same functions with PyTorch, and every Pallas kernel on the
ported path is a CUDA C++ kernel under ``csrc/`` built on first use
(``ops/_build.py``). Nothing here imports JAX or ``layoutdit_tpu``.

Ported so far: the serving path of the ``faster_rcnn`` detector with the
DiT encoder (``eval/serving.py::BatchInferenceEngine``).
"""

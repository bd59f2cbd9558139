"""PyTorch/CUDA port of layoutdit_tpu for NVIDIA Hopper (H100).

The JAX package ``layoutdit_tpu`` stays the reference; this package
computes the same functions with PyTorch, and every Pallas kernel on the
ported path is a CUDA C++ kernel under ``csrc/`` built on first use
(``ops/_build.py``). Nothing here imports JAX or ``layoutdit_tpu``.

Ported so far, with the DiT encoder, for the ``faster_rcnn`` detector
(with its cascade and mask modifiers), the single-stage ``retinanet``
and ``fcos``, and the set-prediction ``detr``: the serving path
(``eval/serving.py::BatchInferenceEngine``) and its export
(``export.py``), the trainer with the JAX trainer's run state
(``train/trainer.py::Trainer``), evaluation and ``main``.
"""

"""Synthetic pretraining of the three networks (port of the JAX package's
``training/``): ``superpoint_train``, ``rcf_train`` and ``superglue_train``.

Gradients run through plain PyTorch forwards over the JAX-layout parameter
pytree, as the JAX trainers run through XLA; the hand kernels are
inference-only and refuse grad-requiring inputs on the card
(``ops/cuda_build.refuse_grad``). The trainers run where JAX runs its
inference on the same path: the shift-pair bank's SuperPoint extraction and
``superglue_train.matching_accuracy``. Trained parameters come back as numpy
pytrees that ``models/weights.py`` loads and ``save_npz_pytree`` writes.
"""

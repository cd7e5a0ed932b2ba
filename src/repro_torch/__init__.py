"""PyTorch/CUDA port of the Gating Dropout reproduction.

Laid out module for module like ``repro`` (the JAX reference), whose
names it keeps: ``configs``, ``kernels``, ``core``, ``models``, ``serve``,
``launch``. The package imports ``torch`` and nothing of ``repro`` or
``jax``; ``bridge`` converts the reference's parameter trees to and from
this package's.

This slice serves the encoder-decoder MoE (``zcode-m3-base``): its MoE
layers run the hand-written Hopper kernels of ``repro_torch.kernels``
(dispatch, grouped matmul, combine) and its decode attention the
flash-decode kernel.
"""

"""PyTorch/CUDA port of the Gating Dropout reproduction.

Laid out module for module like ``repro`` (the JAX reference), whose
names it keeps: ``configs``, ``kernels``, ``core``, ``models``, ``serve``,
``training``, ``optim``, ``data``, ``checkpoint``, ``obs``, ``launch``.
The package imports ``torch`` and nothing of ``repro`` or ``jax``;
``bridge`` converts the reference's parameter trees to and from this
package's.

It trains the encoder-decoder MoE (``zcode-m3-base``) with Gating Dropout
and serves it one-shot (greedy, sampled, beam search) or through the
continuous and paged schedulers. Its MoE layers run the hand-written
Hopper kernels of ``repro_torch.kernels`` (dispatch, grouped matmul and
its backward, combine, or the fused MoE kernel) and its decode attention
the flash-decode kernels (contiguous and paged cache).
"""

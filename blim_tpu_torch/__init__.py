"""blim_tpu_torch: the BLiM text-video rerank system in PyTorch for NVIDIA Hopper.

A port of the JAX package `blim_tpu` that sits beside it. Plain tensor code
is PyTorch; every kernel the JAX package wrote in Pallas for the TPU is a
kernel written by hand for Hopper (`kernels/csrc`). Module names mirror
`blim_tpu`, so each function's reference counterpart sits at the same path.

The package imports torch and never jax, and nothing of `blim_tpu`: the small
JAX-free helpers it needs (configs, prompt layouts, pack schedulers, recall)
are kept here as copies, and the tests pin each copy to its original.

Every entry point takes a `device` argument that defaults to "cuda" and
raises when no GPU is present; pass device="cpu" to run the plain PyTorch
versions of the kernels.
"""

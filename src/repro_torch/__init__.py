"""PyTorch + CUDA port of the OmniInfer serving stack for NVIDIA Hopper.

The JAX package `repro` is the reference; this package mirrors its module
names (`configs`, `core.proxy`, `models`, `kernels`, `serving`) and imports
nothing of it. Entry points run on `cuda` unless the caller passes
`device="cpu"`. The two kernels of the paged serving path (paged prefill,
paged decode) are hand-written CUDA C++ for sm_90a under `kernels/csrc/`,
built on first use; on CPU tensors their wrappers run the plain PyTorch
versions instead.
"""

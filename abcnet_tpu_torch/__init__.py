"""abcnet_tpu_torch — the PyTorch/CUDA port of abcnet_tpu for NVIDIA Hopper.

Molecular image recognition: a 512x512 drawing of a molecule in,
canonical SMILES out. The JAX package `abcnet_tpu` beside this one is
the reference; this package imports nothing of it (and no JAX), and
keeps its own copies of the host code it needs.

Layout mirrors abcnet_tpu: data/ (vocab, labels, augment, pack/unpack,
batching), models/ (UNet, snapshot I/O), ops/ (the hand-written CUDA
kernels, each beside its plain PyTorch version; targets and losses),
train/ (metrics, steps, checkpoints, fit), infer/ (peak decode, graph
assembly), eval/ (scoring), chem/ (the chemistry stack), csrc/ (CUDA
sources, built at first use by utils/build.py). Entry points run on the GPU unless the
caller passes device="cpu".
"""

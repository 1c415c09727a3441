"""abcnet_tpu_torch — the PyTorch/CUDA port of abcnet_tpu for NVIDIA Hopper.

Molecular image recognition: a 512x512 drawing of a molecule in,
canonical SMILES out. The JAX package `abcnet_tpu` beside this one is
the reference; this package imports nothing of it (and no JAX), and
keeps its own copies of the host code it needs.

Layout mirrors abcnet_tpu: data/ (the molecule generator with its
layout, two drawing engines and shipped fonts, degradations, pools;
vocab, labels, augment, pack/unpack, batching, Otsu), models/ (UNet
with its options, UNetS2D, UNetCBAM, weight I/O for every layout), ops/ (the hand-written CUDA kernels, each
beside its plain PyTorch version; targets and losses), parallel/ (process
groups, batch sharding), train/ (metrics, steps, checkpoints, fit, data
parallel), infer/ (peak decode, sharded serving, the int8 backbone,
graph assembly), eval/ (scoring, per-class counts, the n=256
evaluation), chem/ (the chemistry stack, InChI), utils/
(builds, profiling, diagnostics, viz), csrc/ (CUDA sources, built at
first use by utils/build.py). Entry points run on the GPU unless the
caller passes device="cpu".
"""

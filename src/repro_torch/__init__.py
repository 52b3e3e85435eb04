"""OSDP: Optimal Sharded Data Parallel — PyTorch/CUDA port.

Paper: Jiang, Fu, Miao, Nie, Cui — IJCAI 2023 (10.24963/IJCAI.2023/238).

Mirrors the module names of the JAX package `repro` so the counterpart
of each module is easy to find.  Imports torch, never jax, and nothing
of `repro`: the planner is a copy with its imports rewritten.  The
model path runs the hand-written Hopper kernels in `kernels/` (CUDA
C++ under `csrc/`); their plain PyTorch versions serve CPU tensors.
"""
__version__ = "0.1.0"

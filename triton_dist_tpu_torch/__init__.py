"""PyTorch + CUDA port of the TPU package, for NVIDIA H100s.

The JAX package beside this one is the reference; this package imports
neither JAX nor it. Its layout mirrors the reference's, so a module's
counterpart sits at the same path:

  models/   config, dense and paged KV caches, Qwen3, weights, sampling,
            Engine
  layers/   RMSNorm/rope, attention core, TP attention and MLP
  mega/     the decode step as a task graph: tasks, scheduler, builder,
            the Qwen3 dense graph, the tiered runtime
  kernels/  the hand-written Hopper kernels and their plain versions
  quant/    the wire codecs, their error contracts and the TD_QUANT
            policy
  language/ the distributed language: notify / wait / put / barriers
            (device side in csrc/td_dist.cuh)
  runtime/  device resolution, process groups (one process per card),
            symmetric memory, nvcc builds of the kernels
  csrc/     CUDA C++ sources of the kernels

Entry points run on the card (``device="cuda"``) and raise when there is
none, unless the caller asks for ``device="cpu"``. On CPU tensors each
kernel wrapper runs its plain PyTorch version; on CUDA tensors it
launches the kernel or raises.
"""

__version__ = "0.1.0"

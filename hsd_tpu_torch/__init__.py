"""hsd_tpu_torch — Hierarchical Speculative Decoding in PyTorch on an H100.

The port of the JAX package `hsd_tpu` (which stays as the reference). It
imports torch and never jax. Layout mirrors the JAX package:
  verify/   acceptance rules (tokenwise / blockwise / HSD / greedy) and
            the trie verifiers of EAGLE drafting
  models/   the Qwen2/Llama/Mixtral decoder, the EAGLE draft head and
            the HF checkpoint loader
  engine/   KV cache with rollback, speculative and autoregressive loops,
            EAGLE decoding and its continuous-batching slot server
  ops/      quantized linear layers, the hand-written CUDA kernels
            (csrc/*.cu, built with nvcc at first use) and sampling
  eval/     synthetic coupled draft/target pairs (speculative and EAGLE)
  bridge    carries JAX parameters, caches and tries into the port (tests)
  modeling_eagle  the Eagle facade: a base model and an EAGLE head,
            loaded from HF checkpoints (models/loader.py)
"""

__version__ = "0.1.0"

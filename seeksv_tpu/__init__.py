"""seeksv_tpu — structural-variation and virus-integration detection in JAX.

A from-scratch reimplementation of the capability surface of seeksv
(reference: qiukunlong/seeksv) designed for JAX/XLA on an accelerator:
reads are decoded into structure-of-arrays batches, evidence extraction and
scoring run as vectorized/jitted kernels, realignment is an in-framework
seed-and-extend engine, and multi-chip scaling uses jax.sharding meshes.
"""

__version__ = "0.1.0"

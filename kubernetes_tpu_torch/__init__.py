"""PyTorch and CUDA port of the orchestrator's accelerator workloads.

The JAX package ``kubernetes_tpu`` stays the reference; this package
runs the same workloads on an NVIDIA H100 through PyTorch, with every
Pallas kernel of the reference replaced by a CUDA kernel written by
hand for Hopper (``csrc/``, built by ``kernels/build.py``).

Layout mirrors the reference, so each counterpart sits under the same
name: ``workloads/lm.py``, ``workloads/vector_add.py``,
``workloads/ring_attention.py``, ``workloads/checkpoint.py``,
``workloads/metrics_reporter.py``, ``preemption.py`` (its marker
helpers), ``perf/chip_bench.py``, and ``entry.py`` for
``__graft_entry__.py``. This package imports ``torch`` and never
``jax`` or ``kubernetes_tpu``.
"""

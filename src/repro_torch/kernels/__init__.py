"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

* ``csrc/*.cu``  — the kernels, one shared library per source;
* ``build``      — builds them with ``nvcc`` at first use and loads them
  with ``ctypes``;
* ``exprcode``   — lowers an ``Expr`` to a typed postfix program, and
  interprets it on numpy columns (the CPU oracle);
* ``codegen``    — writes a query's program as straight-line CUDA C++, the
  row functions of the relational kernels generated per query;
* ``ops``        — the wrappers: a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel; each keeps a launch count;
* ``ref``        — the plain PyTorch version of each kernel.

Kernels: ``fused_select_agg`` (TPC-H Q6/Q14/Q19), ``grouped_select_agg``
(Q1, Q4 inner), ``grouped_join_agg`` (Q4 outer, Q12), ``kmeans_step``
(``la.KMeansStep``), ``segsum`` (rows summed by segment id; no emitter
calls it, as in the JAX package) and ``flash_attention`` (the LM's
prefill attention under ``attn_mode="pallas"``).
"""

"""The Collection Virtual Machine on PyTorch and hand-written CUDA kernels.

A second execution package beside ``repro``: the same IR, passes and
dataflow frontend (kept here as this package's own copies), lowered onto
torch tensors on an NVIDIA card.  ``repro_torch`` imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.

Layout follows ``repro`` so each module's counterpart is easy to find:

* ``core``          — IR types, expressions, programs, verifier, registry,
  the ``cf``/``rel``/``vec``/``la`` flavors and the rewrite passes
  (``Parallelize``, ``FuseKMeansStep`` among them);
* ``compiler``      — table statistics and the fixed lowering driver;
* ``frontends``     — ``Context`` / ``Frame`` (the dataflow frontend);
* ``relational``    — the torch ``VecTable`` runtime and TPC-H;
* ``backends``      — the vec, cf and la emitters and the eager local
  backend;
* ``kernels``       — CUDA kernels (``csrc``), their wrappers and plain
  PyTorch versions;
* ``convert``       — carries tables and arrays across from numpy (or a
  JAX ``VecTable``'s arrays) onto the device.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

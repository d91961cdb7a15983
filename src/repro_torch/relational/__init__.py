"""Physical relational runtime on torch: padded, masked column blocks.

``runtime`` holds the ``VecTable`` and the vec operators; ``tpch`` the
TPC-H generator, queries and numpy references.
"""

from .runtime import VecTable  # noqa: F401

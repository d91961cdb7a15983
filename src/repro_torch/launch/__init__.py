"""Launchers of the port: ``serve`` (batched greedy decode behind admission
control), ``mesh`` (meshes of ranks for the spmd targets) and ``hermetic``
(the environment of rank subprocesses)."""

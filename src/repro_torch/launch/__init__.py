"""Launchers of the port: ``serve`` (batched greedy decode behind admission control)."""

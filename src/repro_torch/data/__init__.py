"""Deterministic, shardable, resumable synthetic data pipeline."""

from .pipeline import TokenPipeline  # noqa: F401

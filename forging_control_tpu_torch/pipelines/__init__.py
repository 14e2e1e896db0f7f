"""Pipelines: configuration, dataset generation, the surrogate run."""

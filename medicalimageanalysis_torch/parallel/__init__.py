"""Batched cohort pipelines."""

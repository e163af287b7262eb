"""Registration models."""

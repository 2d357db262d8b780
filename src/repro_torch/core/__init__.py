"""Training objectives, gradient accumulation and the scaling model."""

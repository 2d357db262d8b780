"""Metrics registry of the serve plane."""

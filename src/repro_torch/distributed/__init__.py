"""Multi-process layout helpers (the data-parallel runner comes with DDP)."""

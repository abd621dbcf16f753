"""Data parallelism over processes, one per card (parallel/dist.py)."""

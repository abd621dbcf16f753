"""Serving: a trained generator exported with ``torch.export``
(serving/export.py)."""

"""Ingest edge: the canonical table schemas (``schemas.py``)."""

"""Serving loop (counterpart of `repro.train`, serving only)."""

"""Synthetic token data (counterpart of `repro.data`)."""

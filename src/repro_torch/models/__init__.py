"""Model functions over tensors (counterpart of `repro.models`, dense
decoder only)."""

"""Model and run configuration dataclasses (counterpart of `repro.configs`)."""

"""Optimizer and LR schedule (counterpart of `repro.optim`)."""

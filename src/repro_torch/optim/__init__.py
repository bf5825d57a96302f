"""Optimizers of the training slice (counterpart of ``repro/optim``)."""

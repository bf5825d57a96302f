"""Model configs (counterpart of ``repro/configs``): one module per
architecture with its exact published dims and a ``reduced()`` variant."""

"""Training (counterpart of ``repro/train``): the step factories
(``steps``) and the host-side loop (``loop``)."""

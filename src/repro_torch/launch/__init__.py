"""Launchers (counterpart of ``repro/launch``): the training CLI
(``train``) and its meshes (``mesh``)."""

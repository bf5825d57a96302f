"""Train checkpoints and checkpoint payloads: ``arrays.npz`` + ``meta.json``
directories."""

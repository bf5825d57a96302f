"""Checkpoint payloads: ``arrays.npz`` + ``meta.json`` directories."""

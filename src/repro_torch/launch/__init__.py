"""Launchers of the port: ``train`` (any registered arch, with
checkpoints, resume and failure injection)."""

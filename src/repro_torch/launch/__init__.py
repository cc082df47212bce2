"""Launchers (port of ``repro.launch``: the training and serving
launchers)."""

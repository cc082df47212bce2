"""Launchers (port of ``repro.launch``: the training launcher)."""

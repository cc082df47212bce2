"""Synthetic datasets and client partitions (port of ``repro.data``)."""

"""Client training backends (port of ``repro.fl``)."""

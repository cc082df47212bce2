"""Model families (port of ``repro.models``)."""

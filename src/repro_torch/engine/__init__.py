"""Search execution (counterpart of ``repro.engine``)."""

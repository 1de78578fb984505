"""The port's core numerics, index and file format (counterpart of ``repro.core``)."""

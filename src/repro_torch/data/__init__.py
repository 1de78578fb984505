"""Seeded synthetic data (counterpart of ``repro.data``)."""

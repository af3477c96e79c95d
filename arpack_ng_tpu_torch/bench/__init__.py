"""Measurement on the CUDA card: the device-only timer shared by
``chip_smoke.py`` and the probes, and the probes themselves."""

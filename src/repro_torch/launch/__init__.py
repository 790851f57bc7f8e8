"""Launchers (port of :mod:`repro.launch`; the serving driver so far)."""

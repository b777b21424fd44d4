"""Fault tolerance: elastic re-dispatch through BandPilot (``repro/ft``)."""

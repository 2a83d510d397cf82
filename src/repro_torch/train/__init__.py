"""Serving steps of the port (training is not ported yet)."""

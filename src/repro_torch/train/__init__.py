"""Serving steps of the LM side (training is not ported yet)."""

"""Calibration of the quantizer banks."""

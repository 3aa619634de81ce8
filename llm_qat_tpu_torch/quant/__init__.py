"""Fake-quantization math and quantizer calibration."""

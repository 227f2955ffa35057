"""Calibration metric of the quality eval."""

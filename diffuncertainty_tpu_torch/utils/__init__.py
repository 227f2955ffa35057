"""Utilities of the trainer (port of ``diffuncertainty_tpu/utils``)."""

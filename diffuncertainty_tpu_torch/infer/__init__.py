"""Uncertainty inference: the job (``runner``, ``cli``), its per-batch
metrics and the results tree it writes."""

"""Per-batch inference metrics."""

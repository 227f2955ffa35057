"""Per-image Dice and binary GED (torch, batched) and AURC (host numpy)."""

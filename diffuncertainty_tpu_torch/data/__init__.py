"""Host-side data of the toy-128 quality eval (numpy and scipy only)."""

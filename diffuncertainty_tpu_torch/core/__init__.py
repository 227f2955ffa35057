"""Configuration constants, specs and the flax->torch parameter bridge."""

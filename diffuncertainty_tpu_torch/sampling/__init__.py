"""TTA and the prediction sampler of the softmax + MC-dropout path."""

"""TTA and the prediction sampler of the softmax and diffusion paths."""

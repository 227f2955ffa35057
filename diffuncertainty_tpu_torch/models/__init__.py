"""The DiffUnet (softmax and diffusion families), the diffusion process and the model factory."""

"""The DiffUnet (softmax head) and the model factory."""

"""Training runtime (port of ``diffuncertainty_tpu/train``): the softmax
loss, the step with AdamW and EMA, SWAG collection, checkpoints and the
``python -m diffuncertainty_tpu_torch.train`` command."""

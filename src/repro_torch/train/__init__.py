"""Training: AdamW with f32 or blockwise 8-bit moments (``train.optimizer``)."""

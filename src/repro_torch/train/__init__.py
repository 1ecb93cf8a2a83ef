"""Training: optimizers, checkpoints, the loop, and the PointMLP trainer."""

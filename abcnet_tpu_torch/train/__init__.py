"""Training: metrics, train/eval steps, checkpoints, the fit loop."""

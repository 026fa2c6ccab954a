"""Training: losses, optimizers and the multitrack acoustic train step."""

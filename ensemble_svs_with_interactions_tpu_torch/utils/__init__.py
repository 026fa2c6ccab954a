"""Configs, scalers and the flax-to-torch weight bridge."""

"""Losses and the training loops."""

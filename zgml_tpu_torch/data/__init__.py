"""The batch loader."""

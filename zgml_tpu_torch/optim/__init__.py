"""SGD and Adam as plain functions over trees of tensors."""

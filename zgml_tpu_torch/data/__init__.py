"""The batch loader and the MNIST IDX reader / synthetic writer."""

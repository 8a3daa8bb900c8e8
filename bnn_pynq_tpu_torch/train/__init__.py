"""Training-side modules of the port; so far only the dataset loader."""

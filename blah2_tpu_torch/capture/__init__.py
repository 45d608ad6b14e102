"""Sample sources the port carries its own copies of."""

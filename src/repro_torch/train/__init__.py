"""Training: optimizer, batch sources and the loop."""

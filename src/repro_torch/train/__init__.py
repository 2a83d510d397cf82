"""Training (loss, optimizer, train step) and serving steps of the port."""

"""CHAMB-GA core in PyTorch: population, operators, NSGA-II, broker, island
model and engine, batched over a leading island axis."""

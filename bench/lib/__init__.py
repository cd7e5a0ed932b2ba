"""Shared pieces of the benchmark: run plumbing, arithmetic, traffic,
weights, trace reduction, rooflines and model FLOP counts."""

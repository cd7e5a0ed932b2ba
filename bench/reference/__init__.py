"""The plain reference: the benchmark's configurations written out in plain
PyTorch at float32 with TF32 off. It imports nothing of the program and
takes nothing the program made: the benchmark hands it the same seeded
weights and inputs it hands the program."""

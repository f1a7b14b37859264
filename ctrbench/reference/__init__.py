"""The plain reference of the benchmark's configurations: plain float32
PyTorch, TF32 off, no kernel, no cache. It imports nothing of the program."""

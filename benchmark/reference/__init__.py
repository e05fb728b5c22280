"""The plain reference the benchmark judges the program's outputs by.

Plain PyTorch, float64 by default, sequential in time. It imports nothing of
the program: it works out again from the benchmark's own inputs everything
the program derives from them.
"""

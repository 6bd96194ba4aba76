"""Device operators: packed masks, bit-plane compares, reductions, and
the hand-written CUDA kernels (`csrc/`) with their plain twins."""

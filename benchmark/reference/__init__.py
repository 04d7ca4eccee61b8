"""The benchmark's plain reference: the detect -> embed -> track frame step
and the countline counters in plain PyTorch, float32 unless a caller asks
for less.

It is a frozen copy of the plain code of `deepdish_tpu_torch` as of the
benchmark's first version (models, ops, tracker, counting), with the
program's kernels, device module and profiler ranges taken out: the
assignment is always the plain solver, and nothing here imports the
program, JAX or the JAX package. Later changes to the program do not
reach it; the benchmark compares the program against it.
"""

"""Plain PyTorch references of the benchmarked configurations.

Frozen, functional copies of the published models' inference math: every
layer reads its weights from a flat ``{name: tensor}`` dict under the
port's parameter names, computes in float32 (TF32 off) or, for the
control, with every product's operands rounded to float8, and runs one
lane and one frame at a time with no kernels, caches or lane batching.
Nothing here imports the program under test, JAX or the JAX package.
"""

"""PyTorch and CUDA port of mega_pytorch_tpu (MEGA streaming inference) for
NVIDIA Hopper. Module paths mirror the JAX package; the Pallas kernels
become hand-written CUDA kernels under ``csrc/`` bound by ``ops/kernels``."""

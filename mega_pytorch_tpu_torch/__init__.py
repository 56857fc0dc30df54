"""PyTorch and CUDA port of mega_pytorch_tpu (streaming inference of MEGA,
RDN, FGFA and DFF, and the single-frame base detector) for NVIDIA Hopper.
Module paths mirror the JAX package; the Pallas kernels become hand-written
CUDA kernels under ``csrc/`` bound by ``ops/kernels``."""

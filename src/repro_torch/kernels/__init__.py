# Hand-written Hopper kernels, one package each, beside the JAX
# package's Pallas kernels they replace:
#   vfl_matmul  -- the all-clients first-layer matmul (CUDA C++, sm_90a)
# Each package: csrc/ (the CUDA source), ops.py (wrapper, launch count,
# autograd.Function), ref.py (the plain PyTorch version).  build.py
# compiles the sources with nvcc at first use.

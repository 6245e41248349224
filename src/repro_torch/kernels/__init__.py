# Hand-written CUDA kernels for the port's hot spots (sources in ../csrc):
# the fused EF + top-k of the SASG exchange, the Mamba-2 SSD chunk term.
# Each subpackage has:
#   <name>.py  — ctypes launch wrapper of the CUDA kernel + launch counter
#   ops.py     — public entries (plain version on CPU tensors, kernel on CUDA)
#   ref.py     — plain PyTorch version the kernel is held to

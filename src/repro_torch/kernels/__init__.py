"""Hand-written Hopper kernels of the PyTorch port and their plain versions.

`ops` holds the device-dispatching wrappers, `ref` the plain PyTorch
versions, `build` the nvcc build, `csrc/` the CUDA sources.
"""

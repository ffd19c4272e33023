"""Hand-written Hopper kernels of the port, each beside its plain version.

K1 ``col_transfer`` (CUDA C++, ``csrc/col_transfer.cu``): the BTen column
transfer. K2 ``centered_o`` (CUDA C++, ``csrc/centered_o.cu``): the
centered SR sample matrix.
"""

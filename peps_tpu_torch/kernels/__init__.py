"""Hand-written Hopper kernels of the port, each beside its plain version.

K1 ``col_transfer`` (CUDA C++, ``csrc/col_transfer.cu``): the BTen column
transfer. K2 ``centered_o`` (CUDA C++, ``csrc/centered_o.cu``): the
centered SR sample matrix. K3 ``pair_transfer`` (CUDA C++,
``csrc/pair_transfer.cu``): the two-row (BTen2) column transfer of the
pair passes. Each takes float32 and float64 (real bodies) and complex64
and complex128: K2 in a separate complex body, K1 and K3 in their one
kernel template on the shared complex tile products
(``csrc/complex_tiles.cuh``). K4 ``fermion_dress`` (CUDA C++,
``csrc/fermion_dress.cu``): the fermionic sign dressing of a graded TPS
(projection, prefix-flipped projection and candidates), all four dtypes.
K5 ``bmps_overlap`` (CUDA C++, ``csrc/bmps_overlap.cu``): the closure of a
top-type and a bottom-type boundary MPS, one CTA the closures that share a
bottom, all four dtypes. K1's backward ``col_transfer_backward`` (CUDA C++,
``csrc/col_transfer_backward.cu``; under autograd through
:class:`~peps_tpu_torch.kernels.col_transfer.ColTransferFunction`): every
requested gradient of a transfer in one launch, all four dtypes.
"""

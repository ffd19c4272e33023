"""peps_tpu_torch: the PyTorch/CUDA port of peps_tpu for one NVIDIA H100.

Mirrors the JAX package's layout and names; imports torch and numpy, never
jax. The main path is the bosonic OBC VMC train step:
``peps.product_peps -> peps.simple_update -> peps.to_tps ->
algorithm.vmc_optimize.vmc_optimize`` (SR by CG, sketch boundary MPS),
then ``algorithm.measure.measure`` on the optimized state.

float32 matrix products and convolutions run in full float32 (TF32 off),
as the reference runs its sketch Gram in Precision.HIGHEST.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

"""batrack_tpu_torch: the PyTorch/CUDA port of batrack_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports torch and numpy,
never JAX, Flax or any module of the JAX package. Every kernel the JAX
package wrote in Pallas for the TPU is a hand-written CUDA kernel here (sources in csrc/), with a
plain PyTorch version beside it that CPU tensors run.
"""

__version__ = "0.1.0"

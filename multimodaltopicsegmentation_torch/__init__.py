"""PyTorch/CUDA port of multimodaltopicsegmentation_tpu for NVIDIA Hopper.

Module names follow the JAX package, so each module's counterpart is found
under the same path there. The port imports neither JAX nor the JAX package.
"""

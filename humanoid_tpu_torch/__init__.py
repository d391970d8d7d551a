"""humanoid_tpu_torch: the PyTorch/CUDA port of humanoid_tpu.

A second package beside the JAX one, for one NVIDIA H100: the batched
articulated physics with block-PGS contact, the XBot-L walking task and the
PPO trainer, with the 100 Hz control step in one hand-written CUDA kernel
(ops/physics_kernel.py, csrc/control_step.cu). Entry points run on
`device="cuda"` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

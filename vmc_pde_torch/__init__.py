"""PyTorch/CUDA port of vmc_pde_tpu: a normalizing-flow density evolved in
time with the time-dependent variational principle (TDVP), estimated by
Monte Carlo, on one torch device.

The JAX package ``vmc_pde_tpu`` is the reference this port is held
against; this package imports nothing of JAX. Entry point:
``python -m vmc_pde_torch.driver <preset>`` (driver.py). The hand-written
CUDA kernels live in kernels/csrc and are built with nvcc on first use
(kernels/build.py).
"""

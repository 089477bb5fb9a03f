"""Precision policy, the PyTorch counterpart of vmc_pde_tpu/utils/dtypes.py.

Same three roles and the same preset names:

- ``compute``: network evaluation, sampling, per-sample gradients and the
  Gram/force contractions;
- ``solve``: the (P, P) eigensolve or Cholesky solve;
- ``master``: the time integrator's copy of the flat parameters (f64: dt
  ramps from 1e-7, and f32 accumulation of ``theta += dt * k`` would
  under-resolve the update).

PyTorch needs no global x64 switch: every tensor carries its dtype, and the
port creates every tensor with an explicit one (torch's own default is f32).

TF32 is the card's counterpart of the TPU's single-pass bf16 matmul: about
three decimal digits, far too coarse for a Gram matrix whose spectrum spans
many orders of magnitude. ``full_f32_matmuls`` turns it off for matmuls and
convolutions alike, so every Gram, force and covariance contraction runs in
full f32 (the invariant the JAX package keeps with explicit matmul
precision on every statistics contraction). It also turns off cuBLAS's
reduced-precision reductions in bf16 products, whose f32 results the split
Gram backends (parallel/stats.py) sum.
"""

from __future__ import annotations

import dataclasses
import functools

import torch


def full_f32_matmuls() -> None:
    """Make every f32 matmul and convolution full f32 (no TF32), and keep
    bf16 products' reductions in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, device: torch.device,
                    dtype: torch.dtype = None) -> torch.Tensor:
    """The small constant ``values`` on ``device``, made once: a copy
    from host memory waits for the device, and the right-hand side needs
    these constants on every call. Made outside any torch.func transform
    in progress: a tensor made inside one is wrapped at that transform's
    level, and the cached wrapper would escape it."""
    with torch._C._DisableFuncTorch():
        return torch.as_tensor(values, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype policy threaded through the port."""

    compute: torch.dtype = torch.float32
    solve: torch.dtype = torch.float64
    master: torch.dtype = torch.float64

    @classmethod
    def tpu_default(cls) -> "Precision":
        """f32 compute and solve, f64 master parameters (the preset the
        JAX package runs on its accelerator; the name is kept so that
        ``--precision tpu`` means the same policy in both packages)."""
        return cls(compute=torch.float32, solve=torch.float32,
                   master=torch.float64)

    @classmethod
    def tpu_f64stats(cls) -> "Precision":
        """f32 compute with an f64 solve."""
        return cls(compute=torch.float32, solve=torch.float64,
                   master=torch.float64)

    @classmethod
    def f32_only(cls) -> "Precision":
        return cls(compute=torch.float32, solve=torch.float32,
                   master=torch.float32)

    @classmethod
    def f64_everywhere(cls) -> "Precision":
        """Full f64, the reference's semantics (CPU parity tests)."""
        return cls(compute=torch.float64, solve=torch.float64,
                   master=torch.float64)


def resolve(precision: "Precision | str | None") -> Precision:
    if precision is None:
        return Precision.tpu_default()
    if isinstance(precision, Precision):
        return precision
    table = {
        "tpu": Precision.tpu_default,
        "tpu_f64stats": Precision.tpu_f64stats,
        "f32": Precision.f32_only,
        "f64": Precision.f64_everywhere,
    }
    return table[precision]()

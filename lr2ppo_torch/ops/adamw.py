"""AdamW's update of one parameter tensor: the plain PyTorch version and the
hand-written kernel (kernels/csrc/adamw.cu) that gives its bits in one pass.

The kernel replaces no TPU kernel: in the JAX package the update is optax's
chain (lr2ppo_tpu/train/optim.py), which XLA fuses. Eager PyTorch runs the
same chain as ~22 float32 kernels a tensor, each reading and writing whole
float32 temporaries. The kernel is bound by bytes: it reads p, g, m and v
once and writes p, m and v once, 20 bytes an element for the PPO trainer
under --profile fast (float32 parameters and gradients, bfloat16 moments),
28 for tower pretraining (all float32), 14 where all four are bfloat16. It
meets that bound by moving 8 values a thread a step in 16-byte loads and
stores and keeping every intermediate in registers; the source says how.

Two parts:
  * `adamw_reference`, the plain version: AdamW.step's eager loop body,
    which the kernel matches bit for bit on the card;
  * `adamw`, the entry AdamW.step calls per tensor: a CPU tensor takes the
    plain version, any other launches the kernel or raises. `adamw.launches`
    counts the launches.

The kernel takes each tensor as rows of contiguous values, every tensor with
a row stride of its own (`plane`): contiguous tensors are one row, and a
zero1 rank's slice of a parameter along one dim (a view; its moments are
contiguous) is rows of the slice's width.
"""

from __future__ import annotations

from typing import Optional

import torch

from lr2ppo_torch.kernels import build


def adamw_reference(p: torch.Tensor, g: Optional[torch.Tensor],
                    m: torch.Tensor, v: torch.Tensor, lr: float, b1: float,
                    b2: float, eps: float, weight_decay: float,
                    step_scale: float, norm: Optional[torch.Tensor] = None,
                    grad_clip: Optional[float] = None) -> None:
    """The plain version: p, m and v updated in place from the gradient g
    (None: zero) in float32, the moments stored in their own dtype;
    `weight_decay` 0 skips the decay term; `norm`, where given, clips g to
    `grad_clip`."""
    g = (torch.zeros_like(p) if g is None else g).float()
    if norm is not None:
        g = torch.where(norm < grad_clip, g, g / norm * grad_clip)
    mf = m.float().mul_(b1).add_(g * (1 - b1))
    vf = v.float().mul_(b2).add_(torch.square(g).mul_(1 - b2))
    upd = mf * step_scale / (torch.sqrt(vf) + eps)
    if weight_decay:
        upd.add_(p.float() * weight_decay)
    p.add_((upd * -lr).to(p.dtype))
    m.copy_(mf)
    v.copy_(vf)


def plane(*tensors: torch.Tensor) -> tuple:
    """(rows, cols, row strides): a layout of tensors of one shape, each as
    rows of `cols` contiguous values with its own row stride (in values).
    Dims of size 1 drop out, and neighbouring dims merge where they do in
    every tensor. Raises where no such layout exists: more than two dims
    left, or a stride between neighbouring values."""
    if all(t.is_contiguous() for t in tensors):
        n = tensors[0].numel()
        return 1, n, [n] * len(tensors)
    dims: list = []                # (size, [each tensor's stride])
    for i, n in enumerate(tensors[0].shape):
        if n == 1:
            continue
        strides = [t.stride(i) for t in tensors]
        if dims and all(a == n * b for a, b in zip(dims[-1][1], strides)):
            dims[-1] = (dims[-1][0] * n, strides)
        else:
            dims.append((n, strides))
    if not dims:
        return 1, 1, [1] * len(tensors)
    if len(dims) > 2 or any(s != 1 for s in dims[-1][1]):
        raise ValueError(
            "adamw: no layout as rows of contiguous values for shapes and "
            f"strides {[(tuple(t.shape), t.stride()) for t in tensors]}")
    if len(dims) == 1:
        return 1, dims[0][0], [dims[0][0]] * len(tensors)
    return dims[0][0], dims[1][0], dims[0][1]


def _check(p, g, m, v) -> None:
    """The kernel's contract: float32 or bfloat16 tensors of one shape on
    one CUDA device, the moments of one dtype."""
    if not p.is_cuda:
        raise ValueError(f"adamw: no kernel for device {p.device}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t is None:
            continue
        if t.dtype not in build.DTYPE_CODES:
            raise ValueError(f"adamw: {name} is {t.dtype}, not float32 or "
                             "bfloat16")
        if t.device != p.device or t.shape != p.shape:
            raise ValueError(f"adamw: {name} is {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}, the parameter "
                             f"{tuple(p.shape)} on {p.device}")
    if m.dtype != v.dtype:
        raise ValueError(f"adamw: moments of two dtypes, {m.dtype} and "
                         f"{v.dtype}")


def adamw(p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor,
          v: torch.Tensor, lr: float, b1: float, b2: float, eps: float,
          weight_decay: float, step_scale: float,
          norm: Optional[torch.Tensor] = None,
          grad_clip: Optional[float] = None) -> bool:
    """One AdamW update of p, m and v in place (adamw_reference's
    arguments). A CPU tensor takes the plain version; any other launches
    the kernel on p's device's current stream, or raises. Returns whether
    the kernel took the tensor."""
    if p.device.type == "cpu":
        adamw_reference(p, g, m, v, lr, b1, b2, eps, weight_decay,
                        step_scale, norm, grad_clip)
        return False
    fn = build.function("lr2ppo_adamw")
    _check(p, g, m, v)
    if p.numel() == 0:
        return True
    present = [t for t in (p, g, m, v) if t is not None]
    rows, cols, strides = plane(*present)
    if g is None:
        strides.insert(1, 0)
    if norm is not None:
        norm = torch.as_tensor(norm, dtype=torch.float32, device=p.device)
    index = p.get_device()
    codes = build.DTYPE_CODES
    # the Python doubles become float32 in ctypes (its c_float argtypes),
    # rounded to nearest as PyTorch rounds a scalar operand
    args = (p.data_ptr(), None if g is None else g.data_ptr(), m.data_ptr(),
            v.data_ptr(), None if norm is None else norm.data_ptr(),
            rows, cols, *strides, codes[p.dtype],
            codes[p.dtype if g is None else g.dtype], codes[m.dtype],
            -lr, b1, 1 - b1, b2, 1 - b2, eps, weight_decay, step_scale,
            0.0 if grad_clip is None else grad_clip, int(bool(weight_decay)),
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        build.check(build.library_of("lr2ppo_adamw"), err, "adamw launch")
    adamw.launches += 1
    return True


adamw.launches = 0

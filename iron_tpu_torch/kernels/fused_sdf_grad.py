"""Fused SDF core, forward: value, feature and input gradient in one forward
and one reverse sweep, f32 throughout.  K3-fwd, the CUDA kernel in
`csrc/fused_sdf_grad.cu` (counterpart of the forward kernel of
iron_tpu/kernels/fused_sdf_grad.py::make_fused_sdf_grad_fn).

The reverse sweep is the JAX kernel's u-chain: u = e0 at the output,
u_{l-1} = (u_l @ W_l^T) * sigmoid(100 z_{l-1}), and the PE cotangent times
dPE/dy summed per input axis gives the gradient.

The wrapper `sdf_value_feat_grad` launches the kernel for a CUDA tensor (or
raises) and computes `sdf_value_feat_grad_plain`, the same sweeps in plain
PyTorch, for a CPU tensor.  Only the forward is ported: the backward kernel
(`_bwd_kernel` of the JAX module) is not, so the wrapper raises on a CUDA
input that requires grad.  Its `launches` attribute counts kernel launches.

Weight layout (`prepare_grad_weights`): as the bf16 kernels' (PE in the
reference order padded to 48, the layer feeding the skip padded to 256
outputs, the skip split into hidden and PE matrices) but f32, with the skip's
1/sqrt(2) folded into its two matrices and the final layer at its full width.
The reverse sweep reads host-made transposes, so both sweeps read weights
coalesced.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Tuple

import torch

from iron_tpu_torch.core.embedder import positional_encoding
from iron_tpu_torch.fields.sdf import SDFNetwork, softplus100
from iron_tpu_torch.kernels import build
from iron_tpu_torch.kernels.fused_sdf import HID, INV_SQRT2, PE_W, padded_layers

ROWS = 64        # points per tile of the kernel


@dataclass
class GradWeights:
    """SDF weights prepared for K3-fwd and its plain version."""
    mats: List[torch.Tensor]   # f32, layer order (skip: W_h / sqrt 2, W_pe / sqrt 2)
    biases: List[torch.Tensor]  # f32, one per layer (hidden ones padded to 256)
    wfwd: torch.Tensor         # mats, flattened and concatenated
    wt: torch.Tensor           # transposes of the hidden layers' mats, concatenated
    bias_flat: torch.Tensor    # f32 [(n_layers - 1) * 256 + d_out]
    wlast0: torch.Tensor       # f32 [256], the final layer's sdf column
    n_layers: int
    skip: int
    d_embed: int
    multires: int
    d_out: int
    scale: float


def prepare_grad_weights(net: SDFNetwork) -> GradWeights:
    mats, biases, skip = padded_layers(net)
    if skip >= 0:
        mats[skip] = mats[skip] * INV_SQRT2
        mats[skip + 1] = mats[skip + 1] * INV_SQRT2
    hidden = mats[:-1]
    return GradWeights(
        mats=mats, biases=biases,
        wfwd=torch.cat([m.reshape(-1) for m in mats]).contiguous(),
        wt=torch.cat([m.T.contiguous().reshape(-1) for m in hidden]).contiguous(),
        bias_flat=torch.cat(biases).contiguous(),
        wlast0=mats[-1][:, 0].contiguous(),
        n_layers=len(net.layers), skip=skip, d_embed=net.cfg.d_embed,
        multires=net.cfg.multires, d_out=net.cfg.d_out, scale=float(net.cfg.scale))


def _pe_and_d1(w: GradWeights, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """PE(y) and dPE/dy per column, [n, 48] each (zero past d_embed)."""
    pe = positional_encoding(y, w.multires)
    n = y.shape[0]
    d1 = torch.ones((n, 3), dtype=y.dtype, device=y.device)
    if w.multires > 0:
        freqs = 2.0 ** torch.arange(w.multires, dtype=y.dtype, device=y.device)
        ang = y[:, None, :] * freqs[:, None]                         # [n, m, 3]
        f = freqs[None, :, None]
        d = torch.stack([f * torch.cos(ang), -f * torch.sin(ang)], dim=-2)
        d1 = torch.cat([d1, d.reshape(n, -1)], dim=-1)
    pad = lambda t: torch.nn.functional.pad(t, (0, PE_W - t.shape[-1]))
    return pad(pe), pad(d1)


def sdf_value_feat_grad_plain(w: GradWeights, x: torch.Tensor):
    """x [..., 3] -> (sdf [...], feature [..., d_out - 1], grad [..., 3]):
    K3-fwd's sweeps in plain f32 PyTorch, without autograd."""
    shape = x.shape[:-1]
    y = x.reshape(-1, 3) * w.scale
    pe, d1 = _pe_and_d1(w, y)
    h, mi, sp = pe, 0, []
    mat_of = []
    for l in range(w.n_layers):
        mat_of.append(mi)
        z = h @ w.mats[mi]
        mi += 1
        if l == w.skip:
            z = z + pe @ w.mats[mi]
            mi += 1
        z = z + w.biases[l]
        if l < w.n_layers - 1:
            h = softplus100(z)
            sp.append(torch.sigmoid(100.0 * z))
    value, feat = z[:, 0] / w.scale, z[:, 1:]
    # reverse sweep: u = e0 at the output, u_{l-1} = (u_l @ W_l^T) * sigma'(z_{l-1})
    u = w.wlast0 * sp[-1]
    a0cot = torch.zeros_like(pe)
    for l in range(w.n_layers - 2, -1, -1):
        m = w.mats[mat_of[l]]
        if l == w.skip:
            a0cot = a0cot + u @ w.mats[mat_of[l] + 1].T
        vh = u @ m.T
        if l > 0:
            u = vh * sp[l - 1]
        else:
            a0cot = a0cot + vh
    gc = (a0cot * d1)[:, :w.d_embed]
    grad = torch.stack([gc[:, j::3].sum(-1) for j in range(3)], dim=-1)
    return (value.reshape(shape), feat.reshape(shape + (w.d_out - 1,)),
            grad.reshape(shape + (3,)))


def _lib():
    lib = build.load("fused_sdf_grad")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.iron_sdf_value_feat_grad.argtypes = [P, I, P, P, P, P, I, I, I, I, F, P, P, P,
                                                 P, I, P]
        lib.iron_sdf_value_feat_grad.restype = I
        lib.iron_grad_blocks.argtypes = [I]
        lib.iron_grad_blocks.restype = I
        lib._typed = True
    return lib


def sdf_value_feat_grad(w: GradWeights, x: torch.Tensor):
    """K3-fwd: x [..., 3] f32 -> (sdf [...], feature [..., d_out - 1],
    grad [..., 3]), f32.  Replaces the forward kernel of
    iron_tpu/kernels/fused_sdf_grad.py::make_fused_sdf_grad_fn."""
    if not x.is_cuda:
        return sdf_value_feat_grad_plain(w, x)
    if x.requires_grad:
        raise NotImplementedError(
            "the fused SDF core has no backward kernel yet; call it on a "
            "tensor that does not require grad")
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"expected float32 points [..., 3], got {x.dtype} {tuple(x.shape)}")
    for t in (w.wfwd, w.wt, w.bias_flat, w.wlast0):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"prepared weights must be contiguous and on {x.device}")
    shape = x.shape[:-1]
    xf = x.reshape(-1, 3).contiguous()
    n = xf.shape[0]
    dev = xf.device
    value = torch.empty(n, device=dev, dtype=torch.float32)
    feat = torch.empty((n, w.d_out - 1), device=dev, dtype=torch.float32)
    grad = torch.empty((n, 3), device=dev, dtype=torch.float32)
    lib = _lib()
    # persistent blocks, each with its own sigmoid(100 z) scratch of
    # (n_layers - 1) x 64 x 256 f32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-n // ROWS), lib.iron_grad_blocks(sms)))
    scratch = torch.empty(grid * (w.n_layers - 1) * ROWS * HID, device=dev, dtype=torch.float32)
    code = lib.iron_sdf_value_feat_grad(
        xf.data_ptr(), n, w.wfwd.data_ptr(), w.wt.data_ptr(), w.bias_flat.data_ptr(),
        w.wlast0.data_ptr(), w.n_layers, w.skip, w.d_embed, w.d_out, w.scale,
        value.data_ptr(), feat.data_ptr(), grad.data_ptr(), scratch.data_ptr(), grid,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "sdf_value_feat_grad")
    sdf_value_feat_grad.launches += 1
    return (value.reshape(shape), feat.reshape(shape + (w.d_out - 1,)),
            grad.reshape(shape + (3,)))


sdf_value_feat_grad.launches = 0


def make_fused_sdf_grad_fn(net: SDFNetwork):
    """sdf_all(x [..., 3]) -> (sdf, feature, grad) through K3-fwd: the
    shading path's `sdf_all_fn`."""
    w = prepare_grad_weights(net)
    return lambda x: sdf_value_feat_grad(w, x)

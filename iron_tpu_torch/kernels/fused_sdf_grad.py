"""Fused SDF core: value, feature and input gradient in one forward and one
reverse sweep (K3-fwd), and the adjoint of both sweeps (K3-bwd), f32
throughout.  CUDA kernels in `csrc/fused_sdf_grad.cu`, counterparts of the
forward and backward kernels of
iron_tpu/kernels/fused_sdf_grad.py::make_fused_sdf_grad_fn.

The reverse sweep is the JAX kernel's u-chain: u = e0 at the output,
u_{l-1} = (u_l @ W_l^T) * sigmoid(100 z_{l-1}), and the PE cotangent times
dPE/dy summed per input axis gives the gradient.  The backward takes the
cotangents of (value, feature, grad) and returns those of every prepared
matrix, every bias and of x: the hand-derived adjoint of the u-chain (in
forward order) and of the primal chain (in reverse order), as `_bwd_kernel`
of the JAX module computes it.

K5 (`sdf_full`, the counterpart of
iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_fn) is K3-fwd's forward
sweep alone on the same weights: [sdf, features] of every point, f32, no
graph; its plain version is `sdf_full_plain`.

`sdf_value_feat_grad(w, x)` is the entry point.  When x or the prepared
weights need a gradient it runs through `_FusedSdfCore`, a
torch.autograd.Function whose forward is K3-fwd and whose backward is
K3-bwd; otherwise it calls K3-fwd directly.  Each kernel wrapper launches
its kernel for a CUDA tensor (or raises) and computes its plain PyTorch
version (`sdf_value_feat_grad_plain`, `sdf_value_feat_grad_bwd_plain`) for
a CPU tensor.  Each wrapper's `launches` attribute counts kernel launches.

Weight layout (`prepare_grad_weights`): as the bf16 kernels' (PE in the
reference order padded to 48, the layer feeding the skip padded to 256
outputs, the skip split into hidden and PE matrices) but f32, with the skip's
1/sqrt(2) folded into its two matrices and the final layer at its full width.
The transposed products read host-made transposes, so every product reads
its weights coalesced.  K3-bwd runs its products on the tensor cores
(3xTF32, csrc/split3.cuh) and reads both sets packed into mma.sync tf32 B
fragments (`pack_tf32_b`): `bwd_wf` the forward matrices, `bwd_wt` their
transposes and the final layer's, packed at K3-bwd's first use of the
prepared weights.  Under grad mode the prepared matrices are built
differentiably from the live parameters, so autograd carries their
gradients back through the padding, the folded 1/sqrt(2) and the weight
norm to each layer's v, g and b.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from iron_tpu_torch.core.embedder import positional_encoding
from iron_tpu_torch.fields.sdf import SDFNetwork, softplus100
from iron_tpu_torch.kernels import build
from iron_tpu_torch.kernels.fused_sdf import HID, INV_SQRT2, PE_W, layout_layers

ROWS = 64        # points per tile of K3-fwd and K5
OUT_MAX = 264    # widest final layer the backward kernel takes (d_out padded to 8)


@dataclass
class GradWeights:
    """SDF weights prepared for K3 and its plain versions.  `mats` and
    `biases` may carry a graph (differentiable preparation); the flat
    buffers the kernels read never do."""
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
    _bwd_packs: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(default=None, repr=False)

    @property
    def requires_grad(self) -> bool:
        return any(t.requires_grad for t in self.mats + self.biases)

    @property
    def bwd_wf(self) -> torch.Tensor:
        """K3-bwd: pack_tf32_b of the hidden layers' mats."""
        return self._pack_bwd()[0]

    @property
    def bwd_wt(self) -> torch.Tensor:
        """K3-bwd: pack_tf32_b of the hidden layers' transposed mats, then
        of the final layer's (its rows padded to a multiple of 8)."""
        return self._pack_bwd()[1]

    def _pack_bwd(self):
        # packed at the first use and kept: only K3-bwd reads them, so the
        # forward-only callers (K3-fwd, K5, the CPU) never pack
        if self._bwd_packs is None:
            flat = [m.detach() for m in self.mats]
            out_pad = -(-self.d_out // 8) * 8
            last_t = torch.nn.functional.pad(flat[-1].T, (0, 0, 0, out_pad - self.d_out))
            self._bwd_packs = (
                torch.cat([pack_tf32_b(m).reshape(-1) for m in flat[:-1]]),
                torch.cat([pack_tf32_b(m.T).reshape(-1) for m in flat[:-1]]
                          + [pack_tf32_b(last_t).reshape(-1)]))
        return self._bwd_packs


def pack_tf32_b(w: torch.Tensor) -> torch.Tensor:
    """Pack a [8*KS, 8*NT] f32 matrix into mma.sync m16n8k8 tf32 B fragments.

    Output [KS, NT, 32 lanes, 2] f32: lane (g, t) = (lane >> 2, lane & 3) of
    n-tile nt and k-step ks holds W[8 ks + t, 8 nt + g] and
    W[8 ks + t + 4, 8 nt + g], so one lane's fragment is one 8-byte load and
    a warp's loads are contiguous.  The values stay f32: the kernel splits
    them into tf32 hi and lo parts."""
    ks, nt = w.shape[0] // 8, w.shape[1] // 8
    # k = 8 ks + 4 half + t ; n = 8 nt + g
    r = w.detach().to(torch.float32).reshape(ks, 2, 4, nt, 8)
    return r.permute(0, 3, 4, 2, 1).reshape(ks, nt, 32, 2).contiguous()


def prepare_grad_weights(net: SDFNetwork, differentiable: bool = False) -> GradWeights:
    """The prepared weights of `net`; with `differentiable`, `mats` and
    `biases` keep the graph to the network's parameters."""
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        mats, biases, skip = layout_layers(net)
        if skip >= 0:
            mats[skip] = mats[skip] * INV_SQRT2
            mats[skip + 1] = mats[skip + 1] * INV_SQRT2
    if not differentiable:
        mats, biases = [m.detach() for m in mats], [b.detach() for b in biases]
    flat = [m.detach() for m in mats]
    return GradWeights(
        mats=mats, biases=biases,
        wfwd=torch.cat([m.reshape(-1) for m in flat]).contiguous(),
        wt=torch.cat([m.T.contiguous().reshape(-1) for m in flat[:-1]]).contiguous(),
        bias_flat=torch.cat([b.detach() for b in biases]).contiguous(),
        wlast0=flat[-1][:, 0].contiguous(),
        n_layers=len(net.layers), skip=skip, d_embed=net.cfg.d_embed,
        multires=net.cfg.multires, d_out=net.cfg.d_out, scale=float(net.cfg.scale))


def _pe_panels(w: GradWeights, y: torch.Tensor):
    """PE(y), dPE/dy and d2PE/dy2 per column, [n, 48] each (zero past
    d_embed).  Column c belongs to input axis c % 3."""
    pe = positional_encoding(y, w.multires)
    n = y.shape[0]
    d1 = torch.ones((n, 3), dtype=y.dtype, device=y.device)
    d2 = torch.zeros((n, 3), dtype=y.dtype, device=y.device)
    if w.multires > 0:
        freqs = 2.0 ** torch.arange(w.multires, dtype=y.dtype, device=y.device)
        ang = y[:, None, :] * freqs[:, None]                         # [n, m, 3]
        f = freqs[None, :, None, None]
        sc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)    # [n, m, 2, 3]
        d = torch.stack([torch.cos(ang), -torch.sin(ang)], dim=-2)
        d1 = torch.cat([d1, (f * d).reshape(n, -1)], dim=-1)
        d2 = torch.cat([d2, (-f * f * sc).reshape(n, -1)], dim=-1)
    pad = lambda t: torch.nn.functional.pad(t, (0, PE_W - t.shape[-1]))
    return pad(pe), pad(d1), pad(d2)


def _axis_sum(t: torch.Tensor, d_embed: int) -> torch.Tensor:
    """[n, 48] -> [n, 3]: the sum over the columns of each input axis."""
    t = t[:, :d_embed]
    return torch.stack([t[:, j::3].sum(-1) for j in range(3)], dim=-1)


def _forward_chain(w: GradWeights, y: torch.Tensor):
    """The primal chain: (pe, d1, d2, a, z, mat_of) with a[l] the input of
    layer l (a[0] = pe) and z[l] its pre-activation."""
    pe, d1, d2 = _pe_panels(w, y)
    a, z, mat_of = [pe], [], []
    h, mi = pe, 0
    for l in range(w.n_layers):
        mat_of.append(mi)
        zl = h @ w.mats[mi]
        mi += 1
        if l == w.skip:
            zl = zl + pe @ w.mats[mi]
            mi += 1
        zl = zl + w.biases[l]
        z.append(zl)
        if l < w.n_layers - 1:
            h = softplus100(zl)
            a.append(h)
    return pe, d1, d2, a, z, mat_of


def _u_chain(w: GradWeights, z, mat_of, n: int):
    """The reverse sweep: (u, vh, a0cot) with u[L-1] = e0,
    vh[l] = u[l] @ W_l^T, u[l-1] = vh[l] * sigmoid(100 z[l-1])."""
    L = w.n_layers
    u, vh = [None] * L, [None] * L
    u[L - 1] = torch.zeros((n, w.d_out), dtype=z[0].dtype, device=z[0].device)
    u[L - 1][:, 0] = 1.0
    a0cot = torch.zeros((n, PE_W), dtype=z[0].dtype, device=z[0].device)
    for l in range(L - 1, -1, -1):
        vh[l] = u[l] @ w.mats[mat_of[l]].T
        if l == w.skip:
            a0cot = a0cot + u[l] @ w.mats[mat_of[l] + 1].T
        if l > 0:
            u[l - 1] = vh[l] * torch.sigmoid(100.0 * z[l - 1])
        else:
            a0cot = a0cot + vh[l]
    return u, vh, a0cot


@torch.no_grad()
def sdf_value_feat_grad_plain(w: GradWeights, x: torch.Tensor):
    """x [..., 3] -> (sdf [...], feature [..., d_out - 1], grad [..., 3]):
    K3-fwd's sweeps in plain f32 PyTorch, without autograd."""
    shape = x.shape[:-1]
    xf = x.reshape(-1, 3)
    pe, d1, _, _, z, mat_of = _forward_chain(w, xf * w.scale)
    _, _, a0cot = _u_chain(w, z, mat_of, xf.shape[0])
    value, feat = z[-1][:, 0] / w.scale, z[-1][:, 1:]
    grad = _axis_sum(a0cot * d1, w.d_embed)
    return (value.reshape(shape), feat.reshape(shape + (w.d_out - 1,)),
            grad.reshape(shape + (3,)))


@torch.no_grad()
def sdf_full_plain(w: GradWeights, x: torch.Tensor) -> torch.Tensor:
    """x [..., 3] -> [..., d_out] = [sdf, features]: K5's function, the
    forward chain of K3-fwd in plain f32 PyTorch."""
    z = _forward_chain(w, x.reshape(-1, 3) * w.scale)[4][-1]
    out = torch.cat([z[:, :1] / w.scale, z[:, 1:]], dim=-1)
    return out.reshape(x.shape[:-1] + (w.d_out,))


@torch.no_grad()
def sdf_value_feat_grad_bwd_plain(w: GradWeights, x: torch.Tensor, dvalue: torch.Tensor,
                                  dfeat: torch.Tensor, dgrad: torch.Tensor):
    """K3-bwd's function in plain f32 PyTorch, without autograd: the
    cotangents of (value [...], feature [..., d_out - 1], grad [..., 3])
    -> (d mats, d biases, dx [..., 3]).  The hand-derived adjoint of the
    forward chain and the u-chain, as the JAX backward kernel computes it."""
    shape = x.shape[:-1]
    xf = x.reshape(-1, 3)
    n = xf.shape[0]
    mats, L, skip, s = w.mats, w.n_layers, w.skip, w.scale
    pe, d1, d2, a, z, mat_of = _forward_chain(w, xf * s)
    u, vh, a0cot = _u_chain(w, z, mat_of, n)
    sp = [torch.sigmoid(100.0 * zl) for zl in z[:-1]]
    spp = [100.0 * q * (1.0 - q) for q in sp]
    dv = dvalue.reshape(n, 1)
    dg = dgrad.reshape(n, 3)
    dvf = torch.cat([dv / s, dfeat.reshape(n, w.d_out - 1)], dim=-1)

    # output stage: grad_j = sum_c a0cot_c d1_c [axis(c) = j]; d1 depends on
    # x through d2 (dPE/dx = d1 * scale)
    axis = torch.arange(PE_W, device=xf.device) % 3
    dg_col = dg[:, axis]                                           # [n, 48]
    bar_a0cot = dg_col * d1
    dx = _axis_sum(dg_col * a0cot * d2, w.d_embed) * s

    bar_z = [torch.zeros_like(zl) for zl in z]
    bar_z[-1] = dvf
    dW = [torch.zeros_like(m) for m in mats]
    db = [torch.zeros_like(zl[0]) for zl in z]

    # adjoint of the u-chain, forward order
    bar_u = [None] * L
    bar_u[0] = bar_a0cot @ mats[mat_of[0]]
    dW[mat_of[0]] += bar_a0cot.T @ u[0]
    for l in range(1, L):
        li = mat_of[l]
        bar_vh = bar_u[l - 1] * sp[l - 1]
        bar_z[l - 1] = bar_z[l - 1] + bar_u[l - 1] * vh[l] * spp[l - 1]
        bar_u[l] = bar_vh @ mats[li]
        dW[li] += bar_vh.T @ u[l]
        if l == skip:
            bar_u[l] = bar_u[l] + bar_a0cot @ mats[li + 1]
            dW[li + 1] += bar_a0cot.T @ u[l]

    # adjoint of the primal chain, reverse order
    bar_next = None
    bar_a0 = torch.zeros_like(pe)
    for l in range(L - 1, -1, -1):
        bz = bar_z[l] if bar_next is None else bar_z[l] + bar_next * sp[l]
        li = mat_of[l]
        dW[li] += a[l].T @ bz
        db[l] += bz.sum(0)
        bar_a = bz @ mats[li].T
        if l == skip:
            dW[li + 1] += pe.T @ bz
            bar_a0 = bar_a0 + bz @ mats[li + 1].T
        if l > 0:
            bar_next = bar_a
        else:
            bar_a0 = bar_a0 + bar_a
    dx = dx + _axis_sum(bar_a0 * d1, w.d_embed) * s
    return dW, db, dx.reshape(shape + (3,))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    lib = build.load("fused_sdf_grad")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.iron_sdf_value_feat_grad.argtypes = [P, I, P, P, P, P, I, I, I, I, F, P, P, P,
                                                 P, I, P]
        lib.iron_sdf_value_feat_grad.restype = I
        lib.iron_sdf_value_feat_grad_bwd.argtypes = [P, I, P, P, P, P, P, P, I, I, I, I, F, P,
                                                     P, I, I, P, P, I, I, P]
        lib.iron_sdf_value_feat_grad_bwd.restype = I
        lib.iron_grad_blocks.argtypes = [I]
        lib.iron_grad_blocks.restype = I
        lib.iron_grad_bwd_clusters.argtypes = []
        lib.iron_grad_bwd_clusters.restype = I
        lib.iron_sdf_full.argtypes = [P, I, P, P, I, I, I, I, F, P, P]
        lib.iron_sdf_full.restype = I
        lib._typed = True
    return lib


def _check(w: GradWeights, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"expected float32 points [..., 3], got {x.dtype} {tuple(x.shape)}")
    for t in (w.wfwd, w.wt, w.bias_flat, w.wlast0):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"prepared weights must be contiguous and on {x.device}")


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def sdf_value_feat_grad_fwd(w: GradWeights, x: torch.Tensor):
    """K3-fwd: x [..., 3] f32 -> (sdf [...], feature [..., d_out - 1],
    grad [..., 3]), f32, with no graph.  Replaces the forward kernel of
    iron_tpu/kernels/fused_sdf_grad.py::make_fused_sdf_grad_fn."""
    if not x.is_cuda:
        return sdf_value_feat_grad_plain(w, x)
    _check(w, x)
    shape = x.shape[:-1]
    xf = x.detach().reshape(-1, 3).contiguous()
    n = xf.shape[0]
    dev = xf.device
    value = torch.empty(n, device=dev, dtype=torch.float32)
    feat = torch.empty((n, w.d_out - 1), device=dev, dtype=torch.float32)
    grad = torch.empty((n, 3), device=dev, dtype=torch.float32)
    lib = _lib()
    # persistent blocks, each with its own sigmoid(100 z) scratch of
    # (n_layers - 1) x 64 x 256 f32
    grid = max(1, min(-(-n // ROWS), lib.iron_grad_blocks(_sms(dev))))
    scratch = torch.empty(grid * (w.n_layers - 1) * ROWS * HID, device=dev, dtype=torch.float32)
    code = lib.iron_sdf_value_feat_grad(
        xf.data_ptr(), n, w.wfwd.data_ptr(), w.wt.data_ptr(), w.bias_flat.data_ptr(),
        w.wlast0.data_ptr(), w.n_layers, w.skip, w.d_embed, w.d_out, w.scale,
        value.data_ptr(), feat.data_ptr(), grad.data_ptr(), scratch.data_ptr(), grid,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "sdf_value_feat_grad")
    sdf_value_feat_grad_fwd.launches += 1
    return (value.reshape(shape), feat.reshape(shape + (w.d_out - 1,)),
            grad.reshape(shape + (3,)))


sdf_value_feat_grad_fwd.launches = 0


def sdf_full(w: GradWeights, x: torch.Tensor) -> torch.Tensor:
    """K5: x [..., 3] f32 -> [..., d_out] f32, column 0 the sdf, then the
    features, with no graph.  Replaces
    iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_fn."""
    if not x.is_cuda:
        return sdf_full_plain(w, x)
    _check(w, x)
    xf = x.detach().reshape(-1, 3).contiguous()
    out = torch.empty((xf.shape[0], w.d_out), device=xf.device, dtype=torch.float32)
    lib = _lib()
    code = lib.iron_sdf_full(
        xf.data_ptr(), xf.shape[0], w.wfwd.data_ptr(), w.bias_flat.data_ptr(), w.n_layers,
        w.skip, w.d_embed, w.d_out, w.scale, out.data_ptr(),
        torch.cuda.current_stream(xf.device).cuda_stream)
    build.check(lib, code, "sdf_full")
    sdf_full.launches += 1
    return out.reshape(x.shape[:-1] + (w.d_out,))


sdf_full.launches = 0


def bwd_tiling(n: int, clusters: int):
    """(rows, grid clusters) of K3-bwd for n points on a card that holds
    `clusters` clusters of 4 CTAs at once: the fewest rounds of clusters
    that 64-row tiles allow, and in them the shortest tile (a multiple of 16
    rows) that covers the n points, one persistent cluster a tile, at most
    `clusters`."""
    rounds = max(1, -(-n // (64 * clusters)))
    rows = 16 * max(1, -(-n // (16 * clusters * rounds)))
    return rows, max(1, min(-(-n // rows), clusters))


_BWD_CLUSTERS = {}


def sdf_value_feat_grad_bwd(w: GradWeights, x: torch.Tensor, dvalue: torch.Tensor,
                            dfeat: torch.Tensor, dgrad: torch.Tensor):
    """K3-bwd: the cotangents of (value, feature, grad) -> (d mats, d biases,
    dx), f32.  Replaces the backward kernel of
    iron_tpu/kernels/fused_sdf_grad.py::make_fused_sdf_grad_fn (`_bwd_kernel`
    through `_core_bwd`).  Each cluster sums its tiles' dW/db into its own
    partial and a second pass sums the partials in a fixed order, so the
    result does not change from run to run."""
    if not x.is_cuda:
        return sdf_value_feat_grad_bwd_plain(w, x, dvalue, dfeat, dgrad)
    _check(w, x)
    if w.d_out > OUT_MAX:
        raise ValueError(f"the backward kernel takes d_out <= {OUT_MAX}, got {w.d_out}")
    shape = x.shape[:-1]
    xf = x.detach().reshape(-1, 3).contiguous()
    n = xf.shape[0]
    dev = xf.device
    for t in (dvalue, dfeat, dgrad):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"cotangents must be float32 on {dev}")
    dvf = torch.cat([dvalue.reshape(n, 1) / w.scale, dfeat.reshape(n, w.d_out - 1)],
                    dim=-1).contiguous()
    dg = dgrad.reshape(n, 3).contiguous()
    lib = _lib()
    if dev not in _BWD_CLUSTERS:
        _BWD_CLUSTERS[dev] = lib.iron_grad_bwd_clusters()
        if _BWD_CLUSTERS[dev] < 1:
            raise RuntimeError("sdf_value_feat_grad_bwd: the card holds no cluster of the "
                               "backward kernel")
    rows, clusters = bwd_tiling(n, _BWD_CLUSTERS[dev])
    n_w, n_b = w.wfwd.numel(), w.bias_flat.numel()
    stride = n_w + n_b
    # per cluster its dW/db partial; per CTA z, vh and the u-chain's bar_z of
    # its own columns of every hidden layer, for its current tile
    part = torch.empty(clusters * stride, device=dev, dtype=torch.float32)
    scratch = torch.empty(clusters * 4 * 3 * (w.n_layers - 1) * rows * (HID // 4), device=dev,
                          dtype=torch.float32)
    dparams = torch.empty(stride, device=dev, dtype=torch.float32)
    dx = torch.empty((n, 3), device=dev, dtype=torch.float32)
    code = lib.iron_sdf_value_feat_grad_bwd(
        xf.data_ptr(), n, dvf.data_ptr(), dg.data_ptr(), w.bwd_wf.data_ptr(),
        w.bwd_wt.data_ptr(), w.bias_flat.data_ptr(), w.wlast0.data_ptr(), w.n_layers, w.skip,
        w.d_embed, w.d_out, w.scale, dx.data_ptr(), part.data_ptr(), stride, n_w,
        scratch.data_ptr(), dparams.data_ptr(), rows, clusters,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "sdf_value_feat_grad_bwd")
    sdf_value_feat_grad_bwd.launches += 1
    dW = list(torch.split(dparams[:n_w], [m.numel() for m in w.mats]))
    db = list(torch.split(dparams[n_w:], [b.numel() for b in w.biases]))
    return ([d.view(m.shape) for d, m in zip(dW, w.mats)], db, dx.reshape(shape + (3,)))


sdf_value_feat_grad_bwd.launches = 0


class _FusedSdfCore(torch.autograd.Function):
    """(value, feature, grad) of the SDF with K3-fwd as the forward and
    K3-bwd as the backward; inputs x and the prepared mats and biases.  The
    backward's result carries no graph (third derivatives are not needed).
    While `record` is a list, each backward appends its (weights, x,
    cotangents) to it: the inputs a check can replay."""

    record: Optional[list] = None

    @staticmethod
    def forward(ctx, w: GradWeights, x: torch.Tensor, *params):
        ctx.w = w
        ctx.save_for_backward(x)
        return sdf_value_feat_grad_fwd(w, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, dvalue, dfeat, dgrad):
        (x,) = ctx.saved_tensors
        if _FusedSdfCore.record is not None:
            _FusedSdfCore.record.append((ctx.w, x, (dvalue, dfeat, dgrad)))
        dW, db, dx = sdf_value_feat_grad_bwd(ctx.w, x, dvalue, dfeat, dgrad)
        return (None, dx if ctx.needs_input_grad[1] else None, *dW, *db)


def sdf_value_feat_grad(w: GradWeights, x: torch.Tensor):
    """(sdf [...], feature [..., d_out - 1], grad [..., 3]) of the fused
    core.  Differentiable through K3-bwd when grad mode is on and x or the
    prepared weights need a gradient; K3-fwd alone otherwise."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _FusedSdfCore.apply(w, x, *w.mats, *w.biases)
    return sdf_value_feat_grad_fwd(w, x)


def make_fused_sdf_grad_fn(net: SDFNetwork):
    """sdf_all(x [..., 3]) -> (sdf, feature, grad) through K3: the shading
    path's `sdf_all_fn`.  Built under grad mode, its weights are prepared
    differentiably and the result is differentiable through K3-bwd."""
    w = prepare_grad_weights(net, differentiable=torch.is_grad_enabled())
    return lambda x: sdf_value_feat_grad(w, x)


def make_sdf_fn(net: SDFNetwork):
    """sdf_all(x [..., 3]) -> [..., d_out] through K5, without a graph: the
    counterpart of iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_fn (the
    SDF sweep of scripts/bench_sdf_eval_torch.py)."""
    w = prepare_grad_weights(net)
    return lambda x: sdf_full(w, x)

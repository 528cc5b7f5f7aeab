"""SDF evaluators of the sphere tracer on bf16 tensor cores, CUDA kernels in
`csrc/fused_sdf.cu` (counterpart of iron_tpu/kernels/fused_sdf.py): the
coarse K2 (`sdf_only_bf16`) and K1 (`coarse_march`), and the accurate K4
(`sdf_only_3pass`).

K1 and K2 evaluate the positional encoding in f32 and the SDF MLP with bf16
operands, f32 accumulation and f32 bias, rounding each softplus output to
bf16: the precision class of the JAX package's coarse evaluators.  Every
root the coarse march proposes is re-checked by the tracer on the accurate
SDF, so this class affects speed, not the result.

K4 is the accurate trace evaluator of `Stage2Config.trace_pallas`: every
activation h and weight W is split into bf16 halves, hi = bf16(h) and
lo = bf16(h - hi), and each product is hi_h @ hi_W + hi_h @ lo_W +
lo_h @ hi_W with f32 accumulation (the lo @ lo term, 2^-16 relative, is
dropped): the error class of a bf16x3 product, about 1e-5 to 2e-4 on the
sdf, against 1e-2 for K2.  PE and softplus stay f32.

K1 runs the march as one persistent, cooperative launch that keeps a
device-side list of the rays still marching and evaluates only those, in
64-ray tiles, each iteration.  `coarse_march_schedule` is that schedule in
plain PyTorch, with its counts (evaluations, tile-evaluations).  K2 runs
128-row tiles on Hopper's warpgroups, one persistent CTA an SM
(`k2_tiling`).

Each wrapper launches its kernel for a CUDA tensor (or raises) and computes
its plain PyTorch version, with the same arithmetic, for a CPU tensor.  Its
`launches` attribute counts kernel launches.

Weight layout (`prepare_bf16_weights`): the PE keeps the reference column
order, padded to 48 rows (three k-tiles of 16); the layer feeding the skip
is padded to 256 outputs whose rows in the skip matrix are zero; the skip
layer is split into its hidden and PE matrices; the final layer keeps only
the sdf column.  The 256-wide matrices are packed into mma.sync B fragments
(`pack_mma_b`, K1 and K4) and into the swizzled k-tiles that K2's wgmma
reads from shared memory (`pack_wgmma_b`).  K4's weights
(`prepare_3pass_weights`) are two such sets, the hi and the lo halves of the
same f32 layout, with the same biases.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List

import torch

from iron_tpu_torch.core.embedder import positional_encoding
from iron_tpu_torch.fields.sdf import SDFNetwork, softplus100
from iron_tpu_torch.kernels import build

PE_W = 48      # PE width in the kernels, three k-tiles of 16
HID = 256      # the kernels' hidden width
INV_SQRT2 = 1.0 / math.sqrt(2.0)


@dataclass
class Bf16Weights:
    """SDF weights prepared for the bf16 kernels and their plain versions."""
    mats: List[torch.Tensor]   # f32 values of the bf16 matrices, layer order (skip: W_h, W_pe)
    biases: List[torch.Tensor]  # f32, one per layer (hidden ones padded to 256)
    wpack: torch.Tensor        # bf16 mma fragments of mats[:-1], concatenated
    wgpack: torch.Tensor       # bf16 wgmma k-tiles of mats[:-1], concatenated (K2)
    bias_flat: torch.Tensor    # f32 [(n_layers - 1) * 256 + 1]
    wlast: torch.Tensor        # bf16 [256], the final layer's sdf column
    n_layers: int
    skip: int                  # -1 without a skip layer
    d_embed: int
    multires: int
    scale: float


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32 (the kernels' operand rounding)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _pad(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """t zero-padded to [rows, cols] (differentiable)."""
    return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def layout_layers(net: SDFNetwork):
    """The SDF's effective weights in the kernels' f32 layout: (mats,
    biases, skip).  Skip layer: two matrices (hidden rows, PE rows) without
    its 1/sqrt(2); final layer at its full width.  Differentiable: under
    grad mode the mats carry the graph back to each layer's v, g and b."""
    cfg = net.cfg
    if cfg.d_in != 3 or cfg.d_hidden != HID or cfg.d_embed > PE_W or len(cfg.skip_in) > 1:
        raise ValueError(f"the fused SDF kernels take d_in=3, d_hidden={HID}, at most "
                         f"{PE_W} PE columns and one skip; got {cfg}")
    skip = cfg.skip_in[0] if cfg.skip_in else -1
    n = len(net.layers)
    mats, biases = [], []
    for l, layer in enumerate(net.layers):
        w, b = layer.effective_weight(), layer.b
        if l < n - 1:
            w, b = _pad(w, w.shape[0], HID), torch.nn.functional.pad(b, (0, HID - b.shape[0]))
        if l == 0:
            mats.append(_pad(w, PE_W, w.shape[1]))
        elif l == skip:
            d_h = w.shape[0] - cfg.d_embed
            mats += [_pad(w[:d_h], HID, w.shape[1]), _pad(w[d_h:], PE_W, w.shape[1])]
        else:
            mats.append(w)
        biases.append(b)
    return mats, biases, skip


def padded_layers(net: SDFNetwork):
    """`layout_layers` without a graph: the weights of a render and of the
    bf16 kernels."""
    with torch.no_grad():
        mats, biases, skip = layout_layers(net)
    return [m.detach() for m in mats], [b.detach() for b in biases], skip


def pack_mma_b(w: torch.Tensor) -> torch.Tensor:
    """Pack a [16*KT, 256] matrix into mma.sync m16n8k16 B fragments.

    Output [KT, 32 n-tiles, 32 lanes, 4] bf16: lane (g, t) = (lane >> 2,
    lane & 3) of n-tile nt holds W[16kt + 2t + {0, 1}, 8nt + g] then
    W[16kt + 2t + 8 + {0, 1}, 8nt + g], so one lane's fragment is one 8-byte
    load and a warp's loads are contiguous."""
    kt = w.shape[0] // 16
    # k = 16 kt + 8 half + 2 t + pair ; n = 8 nt + g
    r = w.to(torch.bfloat16).reshape(kt, 2, 4, 2, HID // 8, 8)
    return r.permute(0, 4, 5, 2, 1, 3).reshape(kt, HID // 8, 32, 4).contiguous()


def pack_wgmma_b(w: torch.Tensor) -> torch.Tensor:
    """Pack a [16*KT, 256] matrix into KT k-tiles that K2's wgmma reads as
    its B operand from shared memory.

    Output [KT, 4096] bf16, each k-tile 8 KB in the order of a K-major
    operand in the 32-byte swizzle: column n's 16 values of the k-tile are
    32 bytes, two 16-byte halves (k < 8, k >= 8); columns come in atoms of
    8 (256 bytes, one after another); in columns 4-7 of an atom the two
    halves trade places (address bit 4 ^= bit 7).  So W[16 kt + k, n] is
    element 128 (n // 8) + 16 (n % 8) + 8 ((k // 8) ^ ((n % 8) // 4)) + k % 8
    of k-tile kt, and one bulk copy lands a k-tile as the descriptor
    (csrc/sm90.cuh::wgmma_desc_k16_sw32) reads it."""
    kt = w.shape[0] // 16
    # the index is made on w's device: a copy from the host would sync it
    k = torch.arange(16, device=w.device)[:, None]
    n = torch.arange(HID, device=w.device)[None, :]
    dst = 128 * (n // 8) + 16 * (n % 8) + 8 * ((k // 8) ^ ((n % 8) // 4)) + k % 8
    out = torch.empty((kt, 16 * HID), dtype=torch.bfloat16, device=w.device)
    out[:, dst.reshape(-1)] = w.to(torch.bfloat16).reshape(kt, 16 * HID)
    return out


def _round_layout(net: SDFNetwork, mats, biases, skip: int) -> Bf16Weights:
    """The f32 layout `mats` rounded to bf16 and packed (final layer: its
    sdf column only)."""
    last_w, last_b = mats[-1][:, :1], biases[-1][:1]
    mats = [_bf16(m) for m in mats[:-1]] + [_bf16(last_w)]
    biases = biases[:-1] + [last_b]
    return Bf16Weights(
        mats=mats, biases=biases,
        wpack=torch.cat([pack_mma_b(m).reshape(-1) for m in mats[:-1]]),
        wgpack=torch.cat([pack_wgmma_b(m).reshape(-1) for m in mats[:-1]]),
        bias_flat=torch.cat(biases).contiguous(),
        wlast=mats[-1][:, 0].to(torch.bfloat16).contiguous(),
        n_layers=len(net.layers), skip=skip, d_embed=net.cfg.d_embed,
        multires=net.cfg.multires, scale=float(net.cfg.scale))


def prepare_bf16_weights(net: SDFNetwork) -> Bf16Weights:
    return _round_layout(net, *padded_layers(net))


@dataclass
class ThreePassWeights:
    """K4's weights: the bf16 hi and lo halves of the f32 layout, W ~ hi + lo
    to 2^-16 relative.  `lo` carries the same biases as `hi`."""
    hi: Bf16Weights
    lo: Bf16Weights


def prepare_3pass_weights(net: SDFNetwork) -> ThreePassWeights:
    """Counterpart of iron_tpu/kernels/fused_sdf.py::_prepare_3pass_weights on
    the port's layout."""
    mats, biases, skip = padded_layers(net)
    return ThreePassWeights(hi=_round_layout(net, mats, biases, skip),
                            lo=_round_layout(net, [m - _bf16(m) for m in mats], biases, skip))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pe_bf16(w: Bf16Weights, y: torch.Tensor) -> torch.Tensor:
    pe = positional_encoding(y, w.multires)
    return _bf16(torch.nn.functional.pad(pe, (0, PE_W - pe.shape[-1])))


def _mlp_bf16_plain(w: Bf16Weights, pts: torch.Tensor) -> torch.Tensor:
    """[n, 3] -> [n] sdf, the kernels' arithmetic on f32 tensors: bf16
    operands (exact products in f32), f32 sums, bf16 softplus outputs."""
    pe = _pe_bf16(w, pts * w.scale)
    h, mi = pe, 0
    for l in range(w.n_layers - 1):
        acc = h @ w.mats[mi]
        mi += 1
        if l == w.skip:
            acc = (acc + pe @ w.mats[mi]) * INV_SQRT2
            mi += 1
        h = _bf16(softplus100(acc + w.biases[l]))
    return (h @ w.mats[-1][:, 0] + w.biases[-1][0]) * (1.0 / w.scale)


def sdf_only_bf16_plain(w: Bf16Weights, x: torch.Tensor) -> torch.Tensor:
    """x [..., 3] -> sdf [...]: K2's function in plain PyTorch."""
    return _mlp_bf16_plain(w, x.reshape(-1, 3)).reshape(x.shape[:-1])


def _split(h: torch.Tensor):
    """(hi, lo) = (bf16(h), bf16(h - hi)) as f32 tensors."""
    hi = _bf16(h)
    return hi, _bf16(h - hi)


def sdf_only_3pass_plain(w: ThreePassWeights, x: torch.Tensor) -> torch.Tensor:
    """x [..., 3] -> sdf [...]: K4's function in plain PyTorch.  The PE and
    every softplus output are split into hi and lo; each layer sums
    hi @ W_hi + hi @ W_lo + lo @ W_hi (exact products of bf16 values, f32
    sums), the skip as (mm3(h) + mm3(pe)) / sqrt(2), then the f32 bias."""
    hi, lo = w.hi, w.lo
    pts = x.reshape(-1, 3)
    pe = positional_encoding(pts * hi.scale, hi.multires)
    pe = _split(torch.nn.functional.pad(pe, (0, PE_W - pe.shape[-1])))

    def mm3(a, i):
        return a[0] @ hi.mats[i] + a[0] @ lo.mats[i] + a[1] @ hi.mats[i]

    h, mi = pe, 0
    for l in range(hi.n_layers - 1):
        acc = mm3(h, mi)
        mi += 1
        if l == hi.skip:
            acc = (acc + mm3(pe, mi)) * INV_SQRT2
            mi += 1
        h = _split(softplus100(acc + hi.biases[l]))
    s = mm3(h, -1)[:, 0] + hi.biases[-1][0]
    return (s * (1.0 / hi.scale)).reshape(x.shape[:-1])


def coarse_march_plain(w: Bf16Weights, ray_o, ray_d, acc0, work, max_dis,
                       n_iters: int, threshold: float):
    """K1's function in plain PyTorch: (active, acc, sdf), shapes [...].
    Rays march acc += sdf under a live mask until |sdf| <= threshold or
    acc >= max_dis, for at most n_iters steps."""
    shape = work.shape
    ro, rd = ray_o.reshape(-1, 3), ray_d.reshape(-1, 3)
    acc = acc0.reshape(-1)
    md = torch.broadcast_to(max_dis, shape).reshape(-1)
    s = _mlp_bf16_plain(w, ro + rd * acc[:, None])
    act = work.reshape(-1) & (s.abs() > threshold) & (acc < md)
    for _ in range(n_iters):
        if not bool(act.any()):
            break
        acc = acc + torch.where(act, s, 0.0)
        s = torch.where(act, _mlp_bf16_plain(w, ro + rd * acc[:, None]), s)
        act = act & (s.abs() > threshold) & (acc < md)
    return act.reshape(shape), acc.reshape(shape), s.reshape(shape)


def k1_ctas(n: int, card_ctas: int) -> int:
    """K1's persistent grid for n rays: every CTA the card holds at once,
    but no more than the call has 64-ray tiles."""
    return max(1, min(card_ctas, -(-n // 64)))


def coarse_march_schedule(w: Bf16Weights, ray_o, ray_d, acc0, work, max_dis,
                          n_iters: int, threshold: float):
    """K1's schedule in plain PyTorch: the march as the kernel runs it, and
    what it costs.  Iteration -1 evaluates every ray at acc0 in 64-ray tiles
    and lists the rays that march on; iteration i evaluates the 64-ray tiles
    of list i and lists the rays still active.  The kernel's rows are
    independent of one another, so a ray gets the same numbers in any tile
    and at any row.  Returns (active, acc, sdf) as coarse_march_plain does,
    and a dict: rays, marching (rays in `work`), evaluations, iterations (of
    the slowest ray), tile_evals (the 64-ray tile-evaluations of this
    schedule), tile_evals_blocks (those of one 64-ray block a tile marching
    until its slowest ray stops), and per_iteration [(active rays, tiles)]."""
    shape = work.shape
    ro, rd = ray_o.reshape(-1, 3), ray_d.reshape(-1, 3)
    n = ro.shape[0]
    md = torch.broadcast_to(max_dis, shape).reshape(-1)
    wk = work.reshape(-1)
    acc, s = acc0.reshape(-1).clone(), torch.empty(n, dtype=torch.float32, device=ro.device)
    act = torch.zeros(n, dtype=torch.bool, device=ro.device)
    iters = torch.zeros(n, dtype=torch.int64, device=ro.device)
    per_iteration = []
    lst = None   # iteration -1: every ray, in order
    for it in range(-1, n_iters):
        m = n if lst is None else int(lst.numel())
        if m == 0:
            break
        tiles = -(-m // 64)
        per_iteration.append((m, tiles))
        rays_all = torch.arange(m, device=ro.device) if lst is None else lst
        a_all = acc[rays_all] if lst is None else acc[rays_all] + s[rays_all]
        # each listed ray at its own row of an n-row batch: the CPU's BLAS
        # sums a row in an order that depends on its place in the batch (the
        # card's mma does not), and there its place is the one it has in
        # coarse_march_plain
        pts = torch.zeros_like(ro)
        pts[rays_all] = ro[rays_all] + rd[rays_all] * a_all[:, None]
        s_all = _mlp_bf16_plain(w, pts)
        nxt = []
        for t in range(tiles):
            rays, a = rays_all[t * 64:t * 64 + 64], a_all[t * 64:t * 64 + 64]
            sn = s_all[rays]
            keep = (sn.abs() > threshold) & (a < md[rays])
            if lst is None:
                keep = keep & wk[rays]
            else:
                iters[rays] += 1
            acc[rays], s[rays], act[rays] = a, sn, keep
            nxt.append(rays[keep])
        lst = torch.cat(nxt)
    blocks = iters.new_zeros(-(-n // 64)).scatter_reduce(
        0, torch.arange(n, device=ro.device) // 64, iters, "amax")
    stats = {"rays": n, "marching": int(wk.sum()),
             "evaluations": sum(p[0] for p in per_iteration),
             "iterations": len(per_iteration) - 1,
             "tile_evals": sum(p[1] for p in per_iteration),
             "tile_evals_blocks": int((blocks + 1).sum()),
             "per_iteration": per_iteration}
    return act.reshape(shape), acc.reshape(shape), s.reshape(shape), stats


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    lib = build.load("fused_sdf")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.iron_sdf_only_bf16.argtypes = [P, I, P, I, P, P, I, I, I, F, P, I, P]
        lib.iron_sdf_only_bf16.restype = I
        lib.iron_sdf_only_bf16_ctas.argtypes = []
        lib.iron_sdf_only_bf16_ctas.restype = I
        lib.iron_coarse_march_bf16.argtypes = [P, P, P, P, P, I, I, F, P, I, P, P, I, I, I,
                                               F, P, P, P, P, P, I, P]
        lib.iron_coarse_march_bf16.restype = I
        lib.iron_coarse_march_ctas.argtypes = []
        lib.iron_coarse_march_ctas.restype = I
        lib.iron_coarse_march_places.argtypes = []
        lib.iron_coarse_march_places.restype = I
        lib.iron_cooperative_launch.argtypes = []
        lib.iron_cooperative_launch.restype = I
        lib.iron_sdf_only_3pass.argtypes = [P, I, P, P, I, P, P, P, I, I, I, F, P, I, P]
        lib.iron_sdf_only_3pass.restype = I
        lib._typed = True
    return lib


def _check_weights(w: Bf16Weights, dev: torch.device, *extra: torch.Tensor) -> None:
    for t in (w.wpack, w.bias_flat, w.wlast, *extra):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("prepared weights must be contiguous and on the "
                             f"input's device {dev}")


def _points(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"expected float32 points [..., 3], got {x.dtype} {tuple(x.shape)}")
    return x.detach().reshape(-1, 3).contiguous()


K2_ROWS = 128      # rows a K2 CTA takes at a time: two warpgroups of 64


def k2_tiling(n: int, held: int):
    """(rows a CTA takes at a time, grid CTAs) of K2 for n points on a card
    that holds `held` CTAs at once (one an SM): a persistent grid of every
    CTA the card holds, but no more than the call has 128-row tiles."""
    return K2_ROWS, max(1, min(held, -(-n // K2_ROWS)))


_K2_CTAS = {}


def sdf_only_bf16(w: Bf16Weights, x: torch.Tensor) -> torch.Tensor:
    """K2: x [..., 3] f32 -> sdf [...] f32 at the coarse bf16 precision.
    Replaces iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_only_bf16_fn."""
    if not x.is_cuda:
        return sdf_only_bf16_plain(w, x)
    xf = _points(x)
    dev = xf.device
    _check_weights(w, dev, w.wgpack)
    n = xf.shape[0]
    out = torch.empty(n, device=dev, dtype=torch.float32)
    lib = _lib()
    if dev not in _K2_CTAS:
        _K2_CTAS[dev] = lib.iron_sdf_only_bf16_ctas()
        if _K2_CTAS[dev] < 1:
            raise RuntimeError("sdf_only_bf16: the card holds no CTA of K2")
    code = lib.iron_sdf_only_bf16(
        xf.data_ptr(), n, w.wgpack.data_ptr(), w.wgpack.numel() // (16 * HID),
        w.bias_flat.data_ptr(), w.wlast.data_ptr(), w.n_layers, w.skip, w.d_embed, w.scale,
        out.data_ptr(), k2_tiling(n, _K2_CTAS[dev])[1],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "sdf_only_bf16")
    sdf_only_bf16.launches += 1
    return out.reshape(x.shape[:-1])


sdf_only_bf16.launches = 0


def _cooperative_launch(dev: torch.device) -> int:
    """cudaDevAttrCooperativeLaunch of the card (1 or 0; -1 on error)."""
    with torch.cuda.device(dev):
        return _lib().iron_cooperative_launch()


_COOPERATIVE = {}


def coarse_march(w: Bf16Weights, ray_o, ray_d, acc0, work, max_dis,
                 n_iters: int, threshold: float):
    """K1: the whole coarse sphere-trace march -> (active bool, acc f32,
    sdf f32), shapes of `work`.  Replaces
    iron_tpu/kernels/fused_sdf.py::make_pallas_coarse_march_fn.  One
    persistent, cooperative launch that compacts the active rays between
    iterations (`coarse_march_schedule` is its schedule); it does not sync
    the host.  Raises when the card cannot launch a cooperative grid, and
    when the launch is refused (a grid larger than the card holds at once)."""
    if not work.is_cuda:
        return coarse_march_plain(w, ray_o, ray_d, acc0, work, max_dis, n_iters, threshold)
    dev = work.device
    if dev not in _COOPERATIVE:
        _COOPERATIVE[dev] = _cooperative_launch(dev)
    if _COOPERATIVE[dev] != 1:
        raise RuntimeError("coarse_march: the card cannot launch a cooperative grid "
                           "(cudaDevAttrCooperativeLaunch), which K1's grid barrier needs")
    shape = work.shape
    ro, rd = _points(ray_o), _points(ray_d)
    n = ro.shape[0]
    a0 = acc0.detach().reshape(-1).to(torch.float32).contiguous()
    md = torch.broadcast_to(max_dis.detach(), shape).reshape(-1).to(torch.float32).contiguous()
    wk = work.reshape(-1).to(torch.uint8).contiguous()
    if not (rd.shape[0] == a0.shape[0] == md.shape[0] == wk.shape[0] == n):
        raise ValueError("ray_o, ray_d, acc0, work and max_dis must hold one entry per ray")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    _check_weights(w, dev)
    lib = _lib()
    if dev not in _MARCH_CTAS:
        _MARCH_CTAS[dev] = lib.iron_coarse_march_ctas()
        if _MARCH_CTAS[dev] < 1:
            raise RuntimeError("coarse_march: the card holds no CTA of the march kernel")
    acc = torch.empty(n, device=dev, dtype=torch.float32)
    s = torch.empty_like(acc)
    act = torch.empty(n, device=dev, dtype=torch.uint8)
    # two lists of active rays used in turns; each iteration's list length,
    # the grid barrier's count, then the counts that place the CTAs
    lists = torch.empty(2 * n, device=dev, dtype=torch.int32)
    counts = torch.zeros(int(n_iters) + 2 + lib.iron_coarse_march_places(), device=dev,
                         dtype=torch.int32)
    code = lib.iron_coarse_march_bf16(
        ro.data_ptr(), rd.data_ptr(), a0.data_ptr(), wk.data_ptr(), md.data_ptr(), n,
        int(n_iters), float(threshold), w.wpack.data_ptr(), w.wpack.numel() // (16 * HID),
        w.bias_flat.data_ptr(), w.wlast.data_ptr(), w.n_layers, w.skip, w.d_embed, w.scale,
        acc.data_ptr(), s.data_ptr(), act.data_ptr(), lists.data_ptr(), counts.data_ptr(),
        k1_ctas(n, _MARCH_CTAS[dev]), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "coarse_march (cooperative launch)")
    coarse_march.launches += 1
    return act.bool().reshape(shape), acc.reshape(shape), s.reshape(shape)


_MARCH_CTAS = {}
coarse_march.launches = 0


def k4_width(n: int, sms: int) -> int:
    """CTAs of a K4 cluster (each takes 256 / width columns of a 64-row
    tile) for n points on a card of `sms` SMs: the smallest of 1, 2 and 4
    whose grid, width x ceil(n / 64) CTAs, covers the SMs; 4 when none
    does."""
    tiles = -(-n // 64)
    return 1 if tiles >= sms else 2 if 2 * tiles >= sms else 4


def sdf_only_3pass(w: ThreePassWeights, x: torch.Tensor) -> torch.Tensor:
    """K4: x [..., 3] f32 -> sdf [...] f32 at the accurate bf16x3 precision.
    Replaces iron_tpu/kernels/fused_sdf.py::make_pallas_sdf_only_3pass_fn."""
    if not x.is_cuda:
        return sdf_only_3pass_plain(w, x)
    xf = _points(x)
    _check_weights(w.hi, xf.device)
    _check_weights(w.lo, xf.device)
    out = torch.empty(xf.shape[0], device=xf.device, dtype=torch.float32)
    lib = _lib()
    hi, lo = w.hi, w.lo
    sms = torch.cuda.get_device_properties(xf.device).multi_processor_count
    code = lib.iron_sdf_only_3pass(
        xf.data_ptr(), xf.shape[0], hi.wpack.data_ptr(), lo.wpack.data_ptr(),
        hi.wpack.numel() // (16 * HID), hi.bias_flat.data_ptr(), hi.wlast.data_ptr(),
        lo.wlast.data_ptr(), hi.n_layers, hi.skip, hi.d_embed, hi.scale, out.data_ptr(),
        k4_width(xf.shape[0], sms), torch.cuda.current_stream(xf.device).cuda_stream)
    build.check(lib, code, "sdf_only_3pass")
    sdf_only_3pass.launches += 1
    return out.reshape(x.shape[:-1])


sdf_only_3pass.launches = 0


def make_sdf_only_bf16_fn(net: SDFNetwork):
    """sdf(x [..., 3]) -> [...] through K2 (the coarse fallback sweep)."""
    w = prepare_bf16_weights(net)
    return lambda x: sdf_only_bf16(w, x)


def make_sdf_only_3pass_fn(net: SDFNetwork):
    """sdf(x [..., 3]) -> [...] through K4: the tracer's accurate
    `trace_sdf_fn` under `Stage2Config.trace_pallas`."""
    w = prepare_3pass_weights(net)
    return lambda x: sdf_only_3pass(w, x)


def make_coarse_march_fn(net: SDFNetwork, threshold: float = 2.0e-2):
    """march(ray_o, ray_d, acc0, work, max_dis, n_iters) -> (active, acc,
    sdf) through K1, the tracer's `coarse_march_fn`."""
    w = prepare_bf16_weights(net)

    def march(ray_o, ray_d, acc0, work, max_dis, n_iters: int):
        return coarse_march(w, ray_o, ray_d, acc0, work, max_dis, n_iters, threshold)

    return march

"""Multi-view datasets with device-resident ray sampling (counterpart of
iron_tpu/data/dataset.py).

The image stack lives on the device as one tensor, and ray batches are
gathered there: `gen_random_rays` draws its pixels from a torch.Generator on
the device (or takes them as tensors) and makes no host sync.  Rays go
through pixel centres (uv + 0.5); `near_far_from_sphere` is the NeuS mid +- 1
heuristic.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.core.camera import Camera, make_camera
from iron_tpu_torch.data.cameras import load_cam_dict
from iron_tpu_torch.data.io import read_image


def near_far_from_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor):
    """(near, far) [B, 1]: mid -+ 1, mid the ray's closest approach to the
    origin."""
    a = torch.sum(rays_d ** 2, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    mid = 0.5 * (-b) / a
    return mid - 1.0, mid + 1.0


def load_image_folder(data_dir: str, folder_name: str = "image",
                      cam_dict_name: str = "cam_dict_norm.json",
                      mask_dir: Optional[str] = None, apply_mask: bool = False,
                      shard: Optional[Tuple[int, int]] = None):
    """(fpaths, images [N, H, W, 3], Ks [N, 4, 4], W2Cs [N, 4, 4], masks
    [N, H, W, 3]) as numpy arrays from an image folder and its cam dict.
    `shard=(index, count)` keeps only the files i % count == index, chosen
    before any pixel is read."""
    cam_path = os.path.join(data_dir, cam_dict_name)
    if not os.path.isfile(cam_path):
        cam_path = os.path.join(os.path.dirname(data_dir), cam_dict_name)
    cam_dict = load_cam_dict(cam_path)

    fpaths = []
    for ext in ("png", "jpg", "jpeg", "exr"):
        fpaths += glob.glob(os.path.join(data_dir, folder_name, f"*.{ext}"))
    fpaths = sorted(fpaths)
    if shard is not None:
        idx, count = shard
        fpaths = fpaths[idx::count]

    images, Ks, W2Cs, masks, kept = [], [], [], [], []
    for fp in fpaths:
        name = os.path.basename(fp)
        key = name if name in cam_dict else os.path.splitext(name)[0] + ".png"
        if key not in cam_dict:
            continue
        img = read_image(fp)
        m = np.ones_like(img)
        if mask_dir is not None:
            mp = sorted(glob.glob(os.path.join(mask_dir, os.path.splitext(name)[0] + ".*")))
            if mp:
                m = read_image(mp[0])
        if apply_mask:
            img = np.where(m < 0.1, 0.0, img)
        images.append(img)
        masks.append(m)
        Ks.append(cam_dict[key]["K"])
        W2Cs.append(cam_dict[key]["W2C"])
        kept.append(fp)
    return kept, np.stack(images), np.stack(Ks), np.stack(W2Cs), np.stack(masks)


@dataclass
class RayDataset:
    """A multi-view dataset on one device, with ray sampling there."""
    images: torch.Tensor      # [N, H, W, 3]
    masks: torch.Tensor       # [N, H, W, 1]
    Ks: torch.Tensor          # [N, 4, 4]
    W2Cs: torch.Tensor        # [N, 4, 4]
    K_invs: torch.Tensor      # [N, 4, 4]
    C2Ws: torch.Tensor        # [N, 4, 4]
    fpaths: List[str]

    @classmethod
    def from_folder(cls, data_dir: str, folder_name: str = "image",
                    cam_dict_name: str = "cam_dict_norm.json",
                    mask_dir: Optional[str] = None, per_host_shard: bool = False,
                    device="cuda") -> "RayDataset":
        """With per_host_shard, in a run of more than one process
        (dist.mesh.process_index_count) each rank reads and keeps only the
        images i % world == rank: data parallelism over views, each rank
        drawing its rays from its own."""
        shard = None
        if per_host_shard:
            from iron_tpu_torch.dist.mesh import process_index_count
            rank, world = process_index_count()
            shard = (rank, world) if world > 1 else None
        fpaths, imgs, Ks, W2Cs, masks = load_image_folder(data_dir, folder_name,
                                                          cam_dict_name, mask_dir, shard=shard)
        return cls.from_arrays(imgs, Ks, W2Cs, masks[..., :1], fpaths, device=device)

    @classmethod
    def from_arrays(cls, images, Ks, W2Cs, masks=None, fpaths=(), device="cuda") -> "RayDataset":
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        images = t(images)
        masks = (torch.ones(images.shape[:-1] + (1,), device=dev) if masks is None
                 else t(masks))
        Ks, W2Cs = t(Ks), t(W2Cs)
        return cls(images=images, masks=masks, Ks=Ks, W2Cs=W2Cs,
                   K_invs=torch.linalg.inv(Ks), C2Ws=torch.linalg.inv(W2Cs),
                   fpaths=list(fpaths))

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    @property
    def hw(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    @property
    def device(self) -> torch.device:
        return self.images.device

    def camera(self, idx: int) -> Camera:
        H, W = self.hw
        return make_camera(self.Ks[idx].cpu().numpy(), self.W2Cs[idx].cpu().numpy(), H, W,
                           device=self.device)

    def _rays(self, uv: torch.Tensor, K_inv: torch.Tensor, C2W: torch.Tensor):
        """Unit rays through pixel positions uv [..., 2] of one camera."""
        uv_h = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
        d_world = (uv_h @ K_inv[:3, :3].T) @ C2W[:3, :3].T
        rays_d = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
        return C2W[:3, 3].expand(rays_d.shape), rays_d

    def gen_random_rays(self, img_idx, batch_size: int,
                        generator: Optional[torch.Generator] = None,
                        px: Optional[torch.Tensor] = None,
                        py: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pixels of one image -> [B, 10] = rays_o | rays_d | rgb | mask.
        img_idx is an int or a 0-d integer tensor on the device; px, py [B]
        are the pixels, drawn uniformly from `generator` when not given."""
        H, W = self.hw
        dev = self.device
        if px is None:
            px = torch.randint(0, W, (batch_size,), generator=generator, device=dev)
        if py is None:
            py = torch.randint(0, H, (batch_size,), generator=generator, device=dev)
        # a 1-element index tensor: indexing with it gathers on the device
        idx = (img_idx.reshape(1) if isinstance(img_idx, torch.Tensor)
               else torch.full((1,), int(img_idx), dtype=torch.long, device=dev))
        b = idx.expand(px.shape[0])
        color, mask = self.images[b, py, px], self.masks[b, py, px]     # [B, 3], [B, 1]
        uv = torch.stack([px.to(torch.float32), py.to(torch.float32)], dim=-1) + 0.5
        rays_o, rays_d = self._rays(uv, self.K_invs[idx][0], self.C2Ws[idx][0])
        return torch.cat([rays_o, rays_d, color, mask], dim=-1)

    def _pixel_grid(self, resolution_level: int) -> torch.Tensor:
        H, W = self.hw
        l = resolution_level
        tx = torch.linspace(0, W - 1, W // l, device=self.device) + 0.5
        ty = torch.linspace(0, H - 1, H // l, device=self.device) + 0.5
        py, px = torch.meshgrid(ty, tx, indexing="ij")
        return torch.stack([px, py], dim=-1)

    def gen_rays_grid(self, img_idx: int, resolution_level: int = 1):
        """The image's ray grid at a downsample level: (rays_o, rays_d)
        [H // l, W // l, 3]."""
        return self._rays(self._pixel_grid(resolution_level), self.K_invs[img_idx],
                          self.C2Ws[img_idx])

    def gen_rays_between(self, idx_0: int, idx_1: int, ratio: float,
                         resolution_level: int = 1):
        """Rays from a pose between two cameras: rotation slerped (scipy),
        translation lerped, camera 0's intrinsics."""
        from scipy.spatial.transform import Rotation, Slerp
        C2W0 = self.C2Ws[idx_0].cpu().numpy()
        C2W1 = self.C2Ws[idx_1].cpu().numpy()
        rots = Rotation.from_matrix(np.stack([C2W0[:3, :3], C2W1[:3, :3]]))
        rot = Slerp([0, 1], rots)(float(ratio)).as_matrix()
        trans = (1.0 - ratio) * C2W0[:3, 3] + ratio * C2W1[:3, 3]
        uv = self._pixel_grid(resolution_level)
        uv_h = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
        d_cam = uv_h @ self.K_invs[0][:3, :3].T
        d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
        rays_d = d_cam @ torch.as_tensor(rot, dtype=torch.float32, device=self.device).T
        rays_o = torch.as_tensor(trans, dtype=torch.float32, device=self.device).expand(
            rays_d.shape)
        return rays_o, rays_d

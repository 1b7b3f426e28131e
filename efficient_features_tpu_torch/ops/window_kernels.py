"""Per-keypoint kernels: IC moments (K2), BAD descriptors (K3), the
HashSIFT patch warp (K4), the HashSIFT histogram (K5) and the fused HashSIFT
kernel (K11: K5 applied to K4's patch in one launch).

Counterpart of `efficient_features_tpu/ops/window_kernels.py`.  The TPU needs
aligned window DMAs, keypoint sorting and MXU forms to read scattered pixels;
a GPU warp reads them directly, so none of that machinery is carried over.
In particular the TPU's window geometry bounds keypoint size, which splits
its kernels into base and octave-bucket (`_big`) variants with a gather path
beyond `_S_CAP`; here one kernel takes keypoints of any size.
Each wrapper runs its plain version for a CPU tensor and launches its CUDA
kernel for a CUDA tensor; `<wrapper>.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..models.params import HS_ORIENT_MAJOR, bad_params
from . import bad as B
from . import hash_sift as HS
from . import image as I
from . import orientation as O
from .detect_kernels import require_cuda, stream_of


def ic_moments_windows(image: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor) -> torch.Tensor:
    """(N, 2) int32 [m01, m10] IC moments; plain version
    `orientation.ic_moments`."""
    if image.device.type == "cpu":
        return O.ic_moments(image, ys, xs)
    require_cuda(image, torch.uint8, "image")
    h, w = image.shape
    n = ys.shape[0]
    out = torch.empty((n, 2), dtype=torch.int32, device=image.device)
    if n == 0:
        return out
    ys32 = ys.to(torch.int32).contiguous()
    xs32 = xs.to(torch.int32).contiguous()
    require_cuda(ys32, torch.int32, "ys")
    require_cuda(xs32, torch.int32, "xs")
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_ic_moments(image.data_ptr(), h, w, ys32.data_ptr(),
                                xs32.data_ptr(), n, out.data_ptr(),
                                stream_of(image))
        _build.check(rc, "ic_moments_windows")
        ic_moments_windows.launches += 1
    return out


ic_moments_windows.launches = 0


def ic_angles_windows(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """IC angles in degrees (0 where invalid); the moments come from K2 on a
    CUDA tensor and from the plain `orientation.ic_moments` on a CPU
    tensor."""
    return O.angles_from_moments(ic_moments_windows(image, ys, xs), valid)


def _affine_args(x, y, size, angle, scale_factor):
    """[x, y, cos*s, sin*s, s] as contiguous float32 CUDA tensors, the
    keypoint inputs of K3 and K4.  The kernels rebuild m02/m12 from exactly
    these cos*s, sin*s values, so the affine stays consistent with its
    rotation (a precomputed m02 one ulp off breaks the exact u = 0 sample
    of a keypoint on the image corner)."""
    s, cost, sint = B.affine_trig(size.to(torch.float32),
                                  angle.to(torch.float32), scale_factor)
    args = [t.to(torch.float32).contiguous()
            for t in (x, y, cost * s, sint * s, s)]
    for name, t in zip(("x", "y", "cos_s", "sin_s", "s"), args):
        require_cuda(t, torch.float32, name)
    return args


def bad_descriptors_windows_ref(image, x, y, size, angle, valid, nbits: int,
                                scale_factor: float = 1.0) -> torch.Tensor:
    """Plain version of K3: `bad.bad_descriptors` over the image's
    integral."""
    return B.bad_descriptors(I.integral_image_i32(image), x, y, size, angle,
                             valid, nbits=nbits, scale_factor=scale_factor)


def bad_descriptors_windows(image, x, y, size, angle, valid, nbits: int,
                            scale_factor: float = 1.0) -> torch.Tensor:
    """(N, nbits//8) uint8 BAD descriptors of keypoints (x, y, size, angle)
    on a uint8 image; invalid slots give zero rows."""
    if image.device.type == "cpu":
        return bad_descriptors_windows_ref(image, x, y, size, angle, valid,
                                           nbits, scale_factor)
    require_cuda(image, torch.uint8, "image")
    params = bad_params(nbits, str(image.device))
    h, w = image.shape
    n = x.shape[0]
    out = torch.empty((n, nbits // 8), dtype=torch.uint8, device=image.device)
    if n == 0:
        return out
    # integral and trig are torch glue, as in the JAX gather path
    integral = I.integral_image_i32(image)
    args = _affine_args(x, y, size, angle, scale_factor)
    valid_u8 = valid.to(torch.uint8).contiguous()
    require_cuda(valid_u8, torch.uint8, "valid")
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_bad_descriptors(
            integral.data_ptr(), h, w, *(t.data_ptr() for t in args),
            valid_u8.data_ptr(), n, params.boxes.data_ptr(),
            params.thresholds.data_ptr(), nbits, out.data_ptr(),
            stream_of(image))
        _build.check(rc, "bad_descriptors_windows")
        bad_descriptors_windows.launches += 1
    return out


bad_descriptors_windows.launches = 0


def warp_patches_windows_ref(image, x, y, size, angle, valid,
                             scale: float = 1.0) -> torch.Tensor:
    """Plain version of K4: `hash_sift.warp_patches` as u8 rows, zero rows
    for invalid slots."""
    p = HS.warp_patches(image, x, y, size, angle, scale).reshape(-1, 1024)
    return torch.where(valid[:, None], p, torch.zeros_like(p)).to(torch.uint8)


def warp_patches_windows(image, x, y, size, angle, valid,
                         scale: float = 1.0) -> torch.Tensor:
    """(N, 1024) uint8 32x32 patches of keypoints (x, y, size, angle) on a
    uint8 image, bilinear under the keypoint affine; invalid slots give
    zero rows.

    One wrapper and one kernel serve every keypoint size: the kernel reads
    pixels straight from the image, so there is no window plan, no `_big`
    twin for sizes above `_S_BASE`, no gather path above `_S_CAP` and no
    octave buckets."""
    if image.device.type == "cpu":
        return warp_patches_windows_ref(image, x, y, size, angle, valid, scale)
    require_cuda(image, torch.uint8, "image")
    h, w = image.shape
    n = x.shape[0]
    out = torch.empty((n, 1024), dtype=torch.uint8, device=image.device)
    if n == 0:
        return out
    args = _affine_args(x, y, size, angle, scale)[:4]
    valid_u8 = valid.to(torch.uint8).contiguous()
    require_cuda(valid_u8, torch.uint8, "valid")
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_warp_patches(image.data_ptr(), h, w,
                                  *(t.data_ptr() for t in args),
                                  valid_u8.data_ptr(), n, out.data_ptr(),
                                  stream_of(image))
        _build.check(rc, "warp_patches_windows")
        warp_patches_windows.launches += 1
    return out


warp_patches_windows.launches = 0


def hs_hist_from_patches_ref(patches: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: `patch_sift_responses` in the orientation-major
    layout, as u8."""
    d = HS.patch_sift_responses(patches.reshape(-1, 32, 32))[:, 1:]
    return d[:, HS_ORIENT_MAJOR.tolist()].to(torch.uint8)


def hs_hist_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """(N, 128) uint8 quantised SIFT rows in the orientation-major layout
    e[o*16 + rc] from (N, 1024) uint8 patch rows.  An all-zero patch gives
    an all-zero row."""
    if patches.device.type == "cpu":
        return hs_hist_from_patches_ref(patches)
    require_cuda(patches, torch.uint8, "patches")
    if patches.dim() != 2 or patches.shape[1] != 1024:
        raise ValueError(f"patches must be (N, 1024), got "
                         f"{tuple(patches.shape)}")
    if patches.data_ptr() % 8:
        raise ValueError("patches must be 8-byte aligned (the kernel reads "
                         "each row as 8-byte words)")
    n = patches.shape[0]
    out = torch.empty((n, 128), dtype=torch.uint8, device=patches.device)
    if n == 0:
        return out
    plan, wpack = HS.hist_plan_on(str(patches.device))
    lib = _build.library()
    with torch.cuda.device(patches.device):
        rc = lib.eff_hs_hist(patches.data_ptr(), n, plan.data_ptr(),
                             wpack.data_ptr(), HS.ORI_SCALE, out.data_ptr(),
                             stream_of(patches))
        _build.check(rc, "hs_hist_from_patches")
        hs_hist_from_patches.launches += 1
    return out


hs_hist_from_patches.launches = 0


def hs_desc_windows_ref(image, x, y, size, angle, valid,
                        scale: float = 1.0) -> torch.Tensor:
    """Plain version of K11: the plain histogram of the plain warp."""
    return hs_hist_from_patches_ref(
        warp_patches_windows_ref(image, x, y, size, angle, valid, scale))


def hs_desc_windows(image, x, y, size, angle, valid,
                    scale: float = 1.0) -> torch.Tensor:
    """(N, 128) uint8 quantised SIFT rows, orientation-major, of keypoints
    (x, y, size, angle) on a uint8 image: `hs_hist_from_patches` of
    `warp_patches_windows` in one kernel, the patch never leaving the chip.
    On a card the rows equal that two-kernel route byte for byte (one copy
    of the device code, csrc/hs_common.cuh).  Invalid slots give zero rows;
    keypoints of any size."""
    if image.device.type == "cpu":
        return hs_desc_windows_ref(image, x, y, size, angle, valid, scale)
    require_cuda(image, torch.uint8, "image")
    h, w = image.shape
    n = x.shape[0]
    out = torch.empty((n, 128), dtype=torch.uint8, device=image.device)
    if n == 0:
        return out
    args = _affine_args(x, y, size, angle, scale)[:4]
    valid_u8 = valid.to(torch.uint8).contiguous()
    require_cuda(valid_u8, torch.uint8, "valid")
    plan, wpack = HS.hist_plan_on(str(image.device))
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_hs_desc(image.data_ptr(), h, w,
                             *(t.data_ptr() for t in args),
                             valid_u8.data_ptr(), n, plan.data_ptr(),
                             wpack.data_ptr(), HS.ORI_SCALE, out.data_ptr(),
                             stream_of(image))
        _build.check(rc, "hs_desc_windows")
        hs_desc_windows.launches += 1
    return out


hs_desc_windows.launches = 0


def hs_blocks_per_sm() -> tuple[int, int]:
    """(K5, K11) blocks of 8 patches that one SM of the current CUDA device
    holds at once (the CUDA occupancy calculator, with the shared memory
    the kernels ask for)."""
    lib = _build.library()
    got = []
    for fn in (lib.eff_hs_hist_blocks_per_sm, lib.eff_hs_desc_blocks_per_sm):
        blocks = ctypes.c_int(0)
        _build.check(fn(ctypes.byref(blocks)), "hs_blocks_per_sm")
        got.append(blocks.value)
    return got[0], got[1]

"""Per-keypoint kernels: IC moments (K2), BAD descriptors (K3), the
HashSIFT patch warp (K4), the HashSIFT histogram (K5) and the fused HashSIFT
kernel (K11: K5 applied to K4's patch in one launch).

Counterpart of `efficient_features_tpu/ops/window_kernels.py`.  The TPU needs
aligned window DMAs, keypoint sorting and MXU forms to read scattered pixels;
on a GPU a warp or a block per keypoint reads them itself (K3 and K4 stage
the keypoint's window of the image in shared memory), so none of that
machinery is carried over.  In particular the TPU's window geometry bounds keypoint
size, which splits its kernels into base and octave-bucket (`_big`)
variants with a gather path beyond `_S_CAP`; here one kernel takes
keypoints of any size, and decides per keypoint whether its window fits.
The kernels take the keypoints as they come (x, y, size, angle, valid) and
compute the affine themselves, so a wrapper runs no torch op besides
allocating its output.
Each wrapper runs its plain version for a CPU tensor and launches its CUDA
kernel for a CUDA tensor; `<wrapper>.launches` counts kernel launches.

The descriptor kernels (K3, K4, K11) take `origin` (oy, ox) and `frame_hw`
(fh, fw): the image may be a band holding the rows and columns from
`origin` on of a larger frame, and the keypoints are in frame coordinates
(the sharded pipeline's bands, `parallel/sharding.py`).  The defaults are
the whole image, with which nothing changes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..models.params import HS_ORIENT_MAJOR, bad_params
from . import bad as B
from . import hash_sift as HS
from . import image as I
from . import orientation as O
from .detect_kernels import require_cuda, stream_of
from ..utils.profiler import span


def _ic_inputs(image, ys, xs):
    """ys, xs as the IC kernel takes them: contiguous int32 on the card."""
    require_cuda(image, torch.uint8, "image")
    ys32 = ys.to(torch.int32).contiguous()
    xs32 = xs.to(torch.int32).contiguous()
    require_cuda(ys32, torch.int32, "ys")
    require_cuda(xs32, torch.int32, "xs")
    return ys32, xs32


def ic_moments_windows(image: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor) -> torch.Tensor:
    """(N, 2) int32 [m01, m10] IC moments; plain version
    `orientation.ic_moments`.  On a CUDA tensor the moments-only entry of
    K2: every slot summed, no angle."""
    if image.device.type == "cpu":
        return O.ic_moments(image, ys, xs)
    ys32, xs32 = _ic_inputs(image, ys, xs)
    h, w = image.shape
    n = ys32.shape[0]
    out = torch.empty((n, 2), dtype=torch.int32, device=image.device)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_ic_moments(image.data_ptr(), h, w, ys32.data_ptr(),
                                xs32.data_ptr(), None, n, out.data_ptr(),
                                None, stream_of(image))
        _build.check(rc, "ic_moments_windows")
        ic_moments_windows.launches += 1
    return out


ic_moments_windows.launches = 0


def ic_angles_windows_ref(image, ys, xs, valid) -> torch.Tensor:
    """Plain version of K2's angles: `orientation.ic_angles`."""
    return O.ic_angles(image, ys, xs, valid)


def ic_angles_windows(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """(N,) float32 IC angles in degrees, 0 where invalid.  On a CUDA tensor
    K2 sums the moments and turns them into the angle itself (one launch,
    no torch op); an invalid slot reads no pixel."""
    if image.device.type == "cpu":
        return ic_angles_windows_ref(image, ys, xs, valid)
    ys32, xs32 = _ic_inputs(image, ys, xs)
    valid_u8 = _valid_bytes(valid)
    h, w = image.shape
    n = ys32.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=image.device)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_ic_moments(image.data_ptr(), h, w, ys32.data_ptr(),
                                xs32.data_ptr(), valid_u8.data_ptr(), n, None,
                                out.data_ptr(), stream_of(image))
        _build.check(rc, "ic_angles_windows")
        ic_angles_windows.launches += 1
    return out


ic_angles_windows.launches = 0


def ic_angles_from_moments_ref(moments: torch.Tensor) -> torch.Tensor:
    """Plain version of K2's angle step: `orientation.angles_from_moments`
    with every slot valid."""
    return O.angles_from_moments(
        moments, torch.ones(moments.shape[0], dtype=torch.bool,
                            device=moments.device))


def ic_angles_from_moments(moments: torch.Tensor) -> torch.Tensor:
    """(N,) float32 degrees of (N, 2) int32 [m01, m10] moments through K2's
    own angle step on a CUDA tensor (a test entry: the main path never
    leaves the kernel between moments and angle)."""
    if moments.device.type == "cpu":
        return ic_angles_from_moments_ref(moments)
    require_cuda(moments, torch.int32, "moments")
    n = moments.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=moments.device)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(moments.device):
        rc = lib.eff_ic_angles_from_moments(moments.data_ptr(), n,
                                            out.data_ptr(),
                                            stream_of(moments))
        _build.check(rc, "ic_angles_from_moments")
        ic_angles_from_moments.launches += 1
    return out


ic_angles_from_moments.launches = 0


def keypoint_trig_ref(size, angle, scale: float):
    """Plain version of the keypoint trig of K3, K4 and K11
    (`hs::keypoint_trig` in csrc/hs_common.cuh), op by op as the device
    function runs it: s = f32(scale) * size / 32, theta = angle *
    f32(DEG2RAD), cos and sin, (1, 0) where angle < 0, then c = cos * s and
    sn = sin * s.  Returns (s, c, sn), float32."""
    s = float(np.float32(scale)) * size / 32.0
    theta = angle * B.DEG2RAD
    rotated = angle >= 0
    cs = torch.where(rotated, torch.cos(theta), 1.0)
    sn = torch.where(rotated, torch.sin(theta), 0.0)
    return s, cs * s, sn * s


def keypoint_trig(size: torch.Tensor, angle: torch.Tensor, scale: float):
    """(s, c, sn) of each keypoint through the device trig on a CUDA tensor
    (a test entry of `hs::keypoint_trig`)."""
    if size.device.type == "cpu":
        return keypoint_trig_ref(size, angle, scale)
    require_cuda(size, torch.float32, "size")
    require_cuda(angle, torch.float32, "angle")
    n = size.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=size.device)
    if n:
        lib = _build.library()
        with torch.cuda.device(size.device):
            rc = lib.eff_keypoint_trig(size.data_ptr(), angle.data_ptr(), n,
                                       scale, *(o.data_ptr() for o in out),
                                       stream_of(size))
            _build.check(rc, "keypoint_trig")
            keypoint_trig.launches += 1
    return tuple(out)


keypoint_trig.launches = 0


def _frame(image: torch.Tensor, origin, frame_hw) -> tuple[int, ...]:
    """(oy, ox, fh, fw) of an image that holds the rows and columns from
    `origin` on of a `frame_hw` frame (None: the image's shape)."""
    fh, fw = image.shape if frame_hw is None else frame_hw
    return int(origin[0]), int(origin[1]), int(fh), int(fw)


def _valid_bytes(valid: torch.Tensor) -> torch.Tensor:
    """A bool valid mask as the kernels read it: its bytes, contiguous on
    the card (a view, no copy, of a contiguous bool tensor)."""
    out = valid.to(torch.bool).contiguous().view(torch.uint8)
    require_cuda(out, torch.uint8, "valid")
    return out


def _keypoint_args(x, y, size, angle, valid):
    """The keypoint inputs of K3, K4 and K11 as the kernels take them: x,
    y, size and angle as contiguous float32 CUDA tensors and the valid
    mask's bytes; inputs that already are pass through without a copy.
    The kernels compute the affine themselves (`hs::keypoint_trig`)."""
    args = [t.to(torch.float32).contiguous() for t in (x, y, size, angle)]
    for name, t in zip(("x", "y", "size", "angle"), args):
        require_cuda(t, torch.float32, name)
    return args + [_valid_bytes(valid)]


def bad_descriptors_windows_ref(image, x, y, size, angle, valid, nbits: int,
                                scale_factor: float = 1.0, origin=(0, 0),
                                frame_hw=None) -> torch.Tensor:
    """Plain version of K3: `bad.bad_descriptors` over the image's
    integral."""
    return B.bad_descriptors(I.integral_image_i32(image), x, y, size, angle,
                             valid, nbits=nbits, scale_factor=scale_factor,
                             origin=origin, frame_hw=frame_hw)


def bad_descriptors_windows(image, x, y, size, angle, valid, nbits: int,
                            scale_factor: float = 1.0, origin=(0, 0),
                            frame_hw=None) -> torch.Tensor:
    """(N, nbits//8) uint8 BAD descriptors of keypoints (x, y, size, angle)
    on a uint8 image; invalid slots give zero rows.

    On a CUDA tensor K3's own kernels turn the image into the rows: a
    keypoint's boxes come from its window's integral in shared memory
    (`bad.window_plan`), or, for a window too large for that, from the
    whole image's integral, which K3 then builds itself (never on a
    detect_and_compute call, whose windows all fit).  No torch op builds an
    integral, and the kernel computes each keypoint's trig itself.  The
    span `eff/bad.describe` holds the call: the scratch integral, the flag
    and the launch (on the CPU the plain version)."""
    with span("bad.describe"):
        if image.device.type == "cpu":
            return bad_descriptors_windows_ref(image, x, y, size, angle,
                                               valid, nbits, scale_factor,
                                               origin, frame_hw)
        require_cuda(image, torch.uint8, "image")
        frame = _frame(image, origin, frame_hw)
        params = bad_params(nbits, str(image.device))
        h, w = image.shape
        n = x.shape[0]
        out = torch.empty((n, nbits // 8), dtype=torch.uint8,
                          device=image.device)
        if n == 0:
            return out
        kp = _keypoint_args(x, y, size, angle, valid)
        integral = torch.empty((h + 1) * (w + 1), dtype=torch.int32,
                               device=image.device)          # scratch
        flag = torch.empty(1, dtype=torch.int32, device=image.device)
        lib = _build.library()
        with torch.cuda.device(image.device):
            rc = lib.eff_bad_descriptors(
                image.data_ptr(), h, w, *frame,
                *(t.data_ptr() for t in kp), n, scale_factor,
                params.boxes.data_ptr(),
                params.thresholds.data_ptr(), nbits, integral.data_ptr(),
                flag.data_ptr(), out.data_ptr(), stream_of(image))
            _build.check(rc, "bad_descriptors_windows")
            bad_descriptors_windows.launches += 1
        return out


bad_descriptors_windows.launches = 0


def warp_patches_windows_ref(image, x, y, size, angle, valid,
                             scale: float = 1.0, origin=(0, 0),
                             frame_hw=None) -> torch.Tensor:
    """Plain version of K4: `hash_sift.warp_patches` as u8 rows, zero rows
    for invalid slots."""
    p = HS.warp_patches(image, x, y, size, angle, scale, origin,
                        frame_hw).reshape(-1, 1024)
    return torch.where(valid[:, None], p, torch.zeros_like(p)).to(torch.uint8)


def warp_patches_windows(image, x, y, size, angle, valid,
                         scale: float = 1.0, origin=(0, 0),
                         frame_hw=None) -> torch.Tensor:
    """(N, 1024) uint8 32x32 patches of keypoints (x, y, size, angle) on a
    uint8 image, bilinear under the keypoint affine; invalid slots give
    zero rows.

    On a CUDA tensor one launch of K4 and no torch op: the kernel computes
    each keypoint's trig, and samples from the keypoint's window of the
    image staged in shared memory (`hash_sift.warp_window_plan`), or from
    the image for a window too large for that.  One wrapper and one kernel
    serve every keypoint size: no `_big` twin for sizes above `_S_BASE`, no
    gather path above `_S_CAP` and no octave buckets."""
    if image.device.type == "cpu":
        return warp_patches_windows_ref(image, x, y, size, angle, valid, scale,
                                        origin, frame_hw)
    require_cuda(image, torch.uint8, "image")
    frame = _frame(image, origin, frame_hw)
    h, w = image.shape
    n = x.shape[0]
    out = torch.empty((n, 1024), dtype=torch.uint8, device=image.device)
    if n == 0:
        return out
    kp = _keypoint_args(x, y, size, angle, valid)
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_warp_patches(image.data_ptr(), h, w, *frame,
                                  *(t.data_ptr() for t in kp), n, scale,
                                  out.data_ptr(), stream_of(image))
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
                        scale: float = 1.0, origin=(0, 0),
                        frame_hw=None) -> torch.Tensor:
    """Plain version of K11: the plain histogram of the plain warp."""
    return hs_hist_from_patches_ref(
        warp_patches_windows_ref(image, x, y, size, angle, valid, scale,
                                 origin, frame_hw))


def hs_desc_windows(image, x, y, size, angle, valid,
                    scale: float = 1.0, origin=(0, 0),
                    frame_hw=None) -> torch.Tensor:
    """(N, 128) uint8 quantised SIFT rows, orientation-major, of keypoints
    (x, y, size, angle) on a uint8 image: `hs_hist_from_patches` of
    `warp_patches_windows` in one kernel, the patch never leaving the chip.
    On a card the rows equal that two-kernel route byte for byte (one copy
    of the device code, csrc/hs_common.cuh).  Invalid slots give zero rows;
    keypoints of any size."""
    if image.device.type == "cpu":
        return hs_desc_windows_ref(image, x, y, size, angle, valid, scale,
                                   origin, frame_hw)
    require_cuda(image, torch.uint8, "image")
    frame = _frame(image, origin, frame_hw)
    h, w = image.shape
    n = x.shape[0]
    out = torch.empty((n, 128), dtype=torch.uint8, device=image.device)
    if n == 0:
        return out
    kp = _keypoint_args(x, y, size, angle, valid)
    plan, wpack = HS.hist_plan_on(str(image.device))
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_hs_desc(image.data_ptr(), h, w, *frame,
                             *(t.data_ptr() for t in kp), n, scale,
                             plan.data_ptr(),
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

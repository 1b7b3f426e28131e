"""The detect kernels (K1, K7, K8, K9, K13) and their plain versions.

Counterparts of `efficient_features_tpu/ops/pallas_kernels.py`'s
`fast_harris_nms_cells` (K1, csrc/fast_harris_nms_cells.cu),
`fast_harris_nms` (K7, csrc/fast_harris_nms.cu), `fast_harris` (K8,
csrc/fast_harris.cu) and `radius_nms` (K9, csrc/radius_nms.cu), and K13
(csrc/select_cells.cu), the cells route's selection, which has no TPU
kernel (`ops/detect.select_topk_cells` is its plain version).  Each
wrapper runs its plain version (`*_ref`, built from `ops/detect.py`'s dense
functions) for a CPU tensor and launches its CUDA kernel for a CUDA tensor;
it never swaps one for the other.  `<wrapper>.launches` counts the
wrapper's launches: one per call, also for K1 and K7, whose calls run two
kernels (the response map, K8's kernel, then their NMS), and K13, whose
call runs four.

K1 serves every nonmax radius >= 1: its NMS reads the response map in
device memory along the disc's segments (`disc_segments`).  K7's NMS stages
a tile of the map plus its ring of radius - 1 px in shared memory, a plan
for the small radii of its route, radius < 10 (`STAGED_MAX_RADIUS`); K9
runs the same NMS at those radii (with a bool output) and a per-pixel disc
scan above them.
"""
from __future__ import annotations

import torch

from .. import _build
from ..utils import semantics as S
from . import detect as D

STAGED_MAX_RADIUS = 9    # EFF_STAGED_MAX_RADIUS in csrc/eff_kernels.h (K7, K9)


def require_cuda(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    """Check what a CUDA kernel takes: a contiguous `dtype` CUDA tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_image(image: torch.Tensor) -> None:
    require_cuda(image, torch.uint8, "image")
    if image.dim() != 2:
        raise ValueError(f"image must be 2-D, got shape {tuple(image.shape)}")


_DEVICE_DISC_TABLES: dict = {}


def _device_disc_table(radius: int, device: torch.device) -> torch.Tensor:
    """The disc half-widths, entry i for dy = i - (radius - 1), as an int32
    tensor on `device`, made once per (radius, device): a copy per call would sync the host."""
    key = (radius, device)
    if key not in _DEVICE_DISC_TABLES:
        _DEVICE_DISC_TABLES[key] = torch.tensor(
            [wdx for _, wdx in S.disc_row_extents(radius)],
            dtype=torch.int32, device=device)
    return _DEVICE_DISC_TABLES[key]


SEGMENT = 32          # K1: columns of a disc segment, one per lane of a warp
SEGMENT_GROUP = 4     # K1: segments a warp reads between two votes


def disc_segments(radius: int) -> list[tuple[int, int, int, int]]:
    """The open NMS disc as K1 scans it: segments (dy, dx0, dx1, 0) of at
    most SEGMENT columns, rows in the order dy = 0, -1, 1, -2, ... (a larger
    neighbour is most likely near), each row left to right, padded with
    empty segments (dx0 > dx1) to a multiple of SEGMENT_GROUP."""
    extent = dict(S.disc_row_extents(radius))
    order = [0] + [s * d for d in range(1, radius) for s in (-1, 1)]
    segs = [(dy, dx0, min(dx0 + SEGMENT - 1, extent[dy]), 0)
            for dy in order
            for dx0 in range(-extent[dy], extent[dy] + 1, SEGMENT)]
    segs += [(0, 1, 0, 0)] * (-len(segs) % SEGMENT_GROUP)
    return segs


def _device_disc_segments(radius: int, device: torch.device) -> torch.Tensor:
    """`disc_segments` as an (n, 4) int32 tensor on `device`, made once per
    (radius, device): a copy per call would sync the host."""
    key = ("segments", radius, device)
    if key not in _DEVICE_DISC_TABLES:
        _DEVICE_DISC_TABLES[key] = torch.tensor(
            disc_segments(radius), dtype=torch.int32, device=device)
    return _DEVICE_DISC_TABLES[key]


def border_corners(image: torch.Tensor, threshold: int) -> torch.Tensor:
    """Border-valid FAST corners, as every detect kernel gates them."""
    h, w = image.shape
    return (D.fast_corner_mask(image, threshold)
            & D.border_mask(h, w, S.HALF_PATCH_SIZE, image.device))


# ---------------------------------------------------------------------------
# K1: FAST + Harris + disc NMS, cell-reduced output, optional ROI mask
# ---------------------------------------------------------------------------


def fast_harris_nms_cells_ref(image: torch.Tensor, threshold: int,
                              radius: int, mask: torch.Tensor | None = None):
    """Plain version of K1 from the dense functions: returns (cellmax f32,
    cellrow i32, cellcnt i32, cellbits u8), each (ceil(h/8), w); see
    `cells_from_dense` for the layout.  `mask` (bool (h, w), or None) drops
    corners before the NMS: a masked-out corner neither survives nor
    suppresses."""
    corner = border_corners(image, threshold)
    if mask is not None:
        corner = corner & mask
    resp = D.harris_response(image)
    return cells_from_dense(resp, D.radius_nms(resp, corner, radius))


def cells_from_dense(resp: torch.Tensor, surv: torch.Tensor):
    """K1's cell outputs of a (h, w) response map and its survivor map:
    cell (i, x) covers rows 8i..8i+7 of column x; cellmax is the largest
    surviving response there, cellrow the first row that holds it, cellcnt
    the survivors and bit k of cellbits is set when row 8i + k survives.
    Dead cells hold (-inf, INT32_MAX, 0, 0)."""
    h, w = resp.shape
    dev = resp.device
    h8 = -(-h // 8)
    mfin = torch.full((h8 * 8, w), D.RESP_SENTINEL, dtype=torch.float32,
                      device=dev)
    alive = torch.zeros((h8 * 8, w), dtype=torch.bool, device=dev)
    mfin[:h] = torch.where(surv, resp, D.RESP_SENTINEL)
    alive[:h] = surv
    m3 = mfin.reshape(h8, 8, w)
    alive3 = alive.reshape(h8, 8, w)
    cellmax = m3.amax(dim=1)
    rows = torch.arange(h8 * 8, dtype=torch.int32, device=dev).reshape(
        h8, 8, 1)
    cand = (m3 == cellmax[:, None, :]) & alive3
    cellrow = torch.where(cand, rows, D.INT32_MAX).amin(dim=1)
    cellcnt = alive3.sum(dim=1, dtype=torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=dev)).reshape(
        1, 8, 1)
    cellbits = (alive3 * weights).sum(dim=1, dtype=torch.int32).to(
        torch.uint8)
    return cellmax, cellrow, cellcnt, cellbits


def fast_harris_nms_cells(image: torch.Tensor, threshold: int, radius: int,
                          mask: torch.Tensor | None = None):
    """Fused FAST + Harris + disc NMS with cell-reduced output; see
    `fast_harris_nms_cells_ref` for the layout and the mask."""
    if image.device.type == "cpu":
        return fast_harris_nms_cells_ref(image, threshold, radius, mask)
    _require_image(image)
    if radius < 1:
        raise ValueError(f"radius must be >= 1, got {radius}")
    h, w = image.shape
    mask_ptr = None
    if mask is not None:
        require_cuda(mask, torch.bool, "mask")
        if mask.shape != image.shape or mask.device != image.device:
            raise ValueError(f"mask must be {tuple(image.shape)} on "
                             f"{image.device}, got {tuple(mask.shape)} on "
                             f"{mask.device}")
        mask_ptr = mask.data_ptr()
    h8 = -(-h // 8)
    dev = image.device
    cellmax = torch.empty((h8, w), dtype=torch.float32, device=dev)
    cellrow = torch.empty((h8, w), dtype=torch.int32, device=dev)
    cellcnt = torch.empty((h8, w), dtype=torch.int32, device=dev)
    cellbits = torch.empty((h8, w), dtype=torch.uint8, device=dev)
    resp = torch.empty((h, w), dtype=torch.float32, device=dev)   # scratch
    segs = _device_disc_segments(int(radius), dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.eff_fast_harris_nms_cells(
            image.data_ptr(), mask_ptr, h, w, int(threshold), int(radius),
            segs.data_ptr(), segs.shape[0] // SEGMENT_GROUP,
            float(D.HARRIS_S2), resp.data_ptr(),
            cellmax.data_ptr(), cellrow.data_ptr(), cellcnt.data_ptr(),
            cellbits.data_ptr(), stream_of(image))
        _build.check(rc, "fast_harris_nms_cells")
        fast_harris_nms_cells.launches += 1
    return cellmax, cellrow, cellcnt, cellbits


fast_harris_nms_cells.launches = 0


# ---------------------------------------------------------------------------
# K13: the cells route's exact top-k selection, no host read
# ---------------------------------------------------------------------------

def select_cells(cellmax: torch.Tensor, cellrow: torch.Tensor,
                 cellbits: torch.Tensor, h: int, w: int, quota: int):
    """Top `quota` survivors of K1's cells as fixed-shape (ys, xs, resp,
    valid) slots; see `ops/detect.select_topk_cells` (the plain version) for
    the method.  On a CUDA tensor three kernels run, with no torch op
    between them and nothing read back."""
    if cellmax.device.type == "cpu":
        return D.select_topk_cells(cellmax, cellrow, cellbits, h, w, quota)
    for t, dtype, name in ((cellmax, torch.float32, "cellmax"),
                           (cellrow, torch.int32, "cellrow"),
                           (cellbits, torch.uint8, "cellbits")):
        require_cuda(t, dtype, name)
        if t.shape != cellmax.shape or t.shape[0] != -(-h // 8) \
                or t.shape[1] < w:
            raise ValueError(f"{name} must be (ceil(h/8), >= w) like "
                             f"cellmax, got {tuple(t.shape)}")
    if h * w >= 2 ** 31:
        raise ValueError(f"a level of {h}x{w} pixels overflows int32 indices")
    dev = cellmax.device
    quota = min(quota, h * w)
    ys = torch.empty(quota, dtype=torch.int32, device=dev)
    xs = torch.empty(quota, dtype=torch.int32, device=dev)
    resp = torch.empty(quota, dtype=torch.float32, device=dev)
    valid = torch.empty(quota, dtype=torch.bool, device=dev)
    if quota == 0:
        return ys, xs, resp, valid
    lib = _build.library()
    nbytes = lib.eff_select_cells_scratch_bytes(h, w, quota)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _build.check(lib.eff_select_cells(
            cellmax.data_ptr(), cellrow.data_ptr(), cellbits.data_ptr(), h, w,
            cellmax.shape[1], quota, scratch.data_ptr(), nbytes,
            ys.data_ptr(), xs.data_ptr(), resp.data_ptr(), valid.data_ptr(),
            stream_of(cellmax)), "select_cells")
        select_cells.launches += 1
    return ys, xs, resp, valid


select_cells.launches = 0


# ---------------------------------------------------------------------------
# K7: FAST + Harris + disc NMS, dense output (nonmax_radius < 10, no mask)
# ---------------------------------------------------------------------------


def fast_harris_nms_ref(image: torch.Tensor, threshold: int,
                        radius: int) -> torch.Tensor:
    """Plain version of K7: (h, w) f32, the response where a border-valid
    FAST corner survives the disc NMS (ties co-survive), -inf elsewhere."""
    resp = D.harris_response(image)
    surv = D.radius_nms(resp, border_corners(image, threshold), radius)
    return torch.where(surv, resp, D.RESP_SENTINEL)


def fast_harris_nms(image: torch.Tensor, threshold: int,
                    radius: int) -> torch.Tensor:
    """Fused FAST + Harris + disc NMS with a dense output; see
    `fast_harris_nms_ref`."""
    if image.device.type == "cpu":
        return fast_harris_nms_ref(image, threshold, radius)
    _require_image(image)
    if not 1 <= radius <= STAGED_MAX_RADIUS:
        raise ValueError(f"the fast_harris_nms kernel covers nonmax_radius "
                         f"1..{STAGED_MAX_RADIUS}, got {radius}")
    h, w = image.shape
    out = torch.empty((h, w), dtype=torch.float32, device=image.device)
    resp = torch.empty((h, w), dtype=torch.float32, device=image.device)
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_fast_harris_nms(
            image.data_ptr(), h, w, int(threshold), int(radius),
            _device_disc_table(int(radius), image.device).data_ptr(),
            float(D.HARRIS_S2), resp.data_ptr(), out.data_ptr(),
            stream_of(image))
        _build.check(rc, "fast_harris_nms")
        fast_harris_nms.launches += 1
    return out


fast_harris_nms.launches = 0


# ---------------------------------------------------------------------------
# K8: FAST + Harris, dense output without NMS
# ---------------------------------------------------------------------------


def fast_harris_ref(image: torch.Tensor, threshold: int) -> torch.Tensor:
    """Plain version of K8: (h, w) f32, the response at border-valid FAST
    corners, -inf elsewhere."""
    return torch.where(border_corners(image, threshold),
                       D.harris_response(image), D.RESP_SENTINEL)


def fast_harris(image: torch.Tensor, threshold: int) -> torch.Tensor:
    """Fused FAST + Harris with a dense output; see `fast_harris_ref`."""
    if image.device.type == "cpu":
        return fast_harris_ref(image, threshold)
    _require_image(image)
    h, w = image.shape
    out = torch.empty((h, w), dtype=torch.float32, device=image.device)
    lib = _build.library()
    with torch.cuda.device(image.device):
        rc = lib.eff_fast_harris(image.data_ptr(), h, w, int(threshold),
                                 float(D.HARRIS_S2), out.data_ptr(),
                                 stream_of(image))
        _build.check(rc, "fast_harris")
        fast_harris.launches += 1
    return out


fast_harris.launches = 0


# ---------------------------------------------------------------------------
# K9: disc NMS of a -inf-masked response, any radius
# ---------------------------------------------------------------------------


def radius_nms_ref(resp: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of K9: (h, w) bool survivor map of a -inf-masked
    response, center != -inf and center >= max over the open disc."""
    return D.radius_nms(resp, resp != D.RESP_SENTINEL, radius)


def radius_nms(resp: torch.Tensor, radius: int) -> torch.Tensor:
    """Disc NMS of a -inf-masked (h, w) f32 response, any radius >= 1; see
    `radius_nms_ref`.  One launch: K7's staged NMS at radius <= 9 (the
    route's radii), a per-pixel disc scan above."""
    if resp.device.type == "cpu":
        return radius_nms_ref(resp, radius)
    require_cuda(resp, torch.float32, "resp")
    if resp.dim() != 2:
        raise ValueError(f"resp must be 2-D, got shape {tuple(resp.shape)}")
    if radius < 1:
        raise ValueError(f"radius must be >= 1, got {radius}")
    h, w = resp.shape
    out = torch.empty((h, w), dtype=torch.bool, device=resp.device)
    table = _device_disc_table(int(radius), resp.device)
    lib = _build.library()
    with torch.cuda.device(resp.device):
        rc = lib.eff_radius_nms(resp.data_ptr(), h, w, int(radius),
                                table.data_ptr(), out.data_ptr(),
                                stream_of(resp))
        _build.check(rc, "radius_nms")
        radius_nms.launches += 1
    return out


radius_nms.launches = 0

// C ABI of the port's hand-written Hopper kernels.
//
// Each entry point launches its kernel (K1 and K7 two, K6 three, K3 four) on
// `stream` (a
// cudaStream_t passed as void*), does not synchronise, allocates nothing,
// and returns cudaGetLastError() right after the launch (0 on success).
// Outputs and
// inputs are device pointers to contiguous row-major tensors that the Python
// wrappers (ops/detect_kernels.py, ops/window_kernels.py, ops/matcher.py,
// ops/image.py) allocate and check.
#pragma once

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// Largest nonmax radius of K7, whose route serves radius < 10: its NMS
// kernel stages a tile of the response map with a ring of radius - 1 px.
#define EFF_STAGED_MAX_RADIUS 9

// K1: FAST-9 + Harris + disc NMS, reduced to 8-row x 1-col cells, any
// radius >= 1; two kernels on `stream`.
// img: (h, w) uint8; mask: (h, w) uint8 ROI (nonzero = search here) or NULL
// for none.  disc_segs: DEVICE (4 * seg_groups, 4) int32, 16-byte aligned:
// the open disc cut into segments (dy, dx0, dx1, 0) of at most 32 columns,
// rows in the order dy = 0, -1, 1, -2, ..., padded with empty segments
// (dx0 > dx1) to a multiple of 4 (ops/detect_kernels.disc_segments).
// resp: (h, w) float32 scratch, left holding the masked response map.
// Outputs are (ceil(h/8), w): cell max response (-inf if no survivor), lowest
// global row of a maximal survivor (INT32_MAX if none), survivor count.
int eff_fast_harris_nms_cells(const uint8_t* img, const uint8_t* mask, int h,
                              int w, int threshold, int radius,
                              const int32_t* disc_segs, int seg_groups,
                              float harris_s2, float* resp, float* cellmax,
                              int32_t* cellrow, int32_t* cellcnt,
                              void* stream);

// K2: intensity-centroid moments over the radius-15 U_MAX disc.
// img: (h, w) uint8; ys, xs: (n,) int32.  out: (n, 2) int32 [m01, m10].
// Reads clamp to the image.
int eff_ic_moments(const uint8_t* img, int h, int w, const int32_t* ys,
                   const int32_t* xs, int n, int32_t* out, void* stream);

// K3: BAD descriptors from the image itself; four kernels on `stream`.
// img: (img_h, img_w) uint8.  kx, ky, cos_s, sin_s, s: (n,) float32
// (cos_s = cos*s, sin_s = sin*s, s >= 0); valid: (n,) uint8.  boxes: (5,
// nbits) float32 rows x1, x2, y1, y2, radius; thresholds: (nbits,); nbits
// 256 or 512.  integral: (img_h+1)*(img_w+1) int32 scratch, built only when
// a valid keypoint's window exceeds the shared-memory plan
// (ops/bad.window_plan); flag: one int32 of scratch.  out: (n, nbits/8)
// uint8, bits MSB-first.
int eff_bad_descriptors(const uint8_t* img, int img_h, int img_w,
                        const float* kx, const float* ky, const float* cos_s,
                        const float* sin_s, const float* s,
                        const uint8_t* valid, int n, const float* boxes,
                        const float* thresholds, int nbits, int32_t* integral,
                        int32_t* flag, uint8_t* out, void* stream);

// K4: HashSIFT patch warp, any keypoint size.  img: (h, w) uint8;
// kx, ky, cos_s, sin_s: (n,) float32; valid: (n,) uint8.  out: (n, 1024)
// uint8 32x32 patches, row-major; invalid slots get zero rows.
int eff_warp_patches(const uint8_t* img, int h, int w, const float* kx,
                     const float* ky, const float* cos_s, const float* sin_s,
                     const uint8_t* valid, int n, uint8_t* out, void* stream);

// K5: HashSIFT histogram.  patches: (n, 1024) uint8, 8-byte aligned;
// plan: (16, 6) int32 and wpack: (2601,) float32, the spatial bins and
// their weights in walk order (ops/hash_sift.hist_plan); ori_scale:
// orientation bins per radian as float32.  out: (n, 128) uint8,
// orientation-major e[o*16 + rc], 8-byte aligned; an all-zero patch gives
// a zero row.
int eff_hs_hist(const uint8_t* patches, int n, const int32_t* plan,
                const float* wpack, float ori_scale, uint8_t* out,
                void* stream);

// K6: best-2 Hamming search; three kernels on `stream`.  q: (n1, nbytes)
// and t: (n2, nbytes) uint8 descriptors, 16-byte aligned, nbytes 32 or 64;
// valid_q (n1,) and valid_t (n2,) uint8 masks, or NULL for all valid.
// split_len: train rows per block, a multiple of 128, at most 65536.
// scratch: 16-byte aligned int32 array of
//   ceil(n2 / 128) * 128 + ceil(n1 / 4) * 4 + 3 * ceil(n2 / split_len) * n1
// entries (ops/matcher.knn2_plan).  Per query row: best_idx (lowest index of
// the nearest train row), best and second (int32; a pair with an invalid
// side counts 1 << 30, second is INT32_MAX when n2 == 1).
int eff_knn2_hamming(const uint8_t* q, const uint8_t* valid_q, int n1,
                     const uint8_t* t, const uint8_t* valid_t, int n2,
                     int nbytes, int split_len, int32_t* scratch,
                     int32_t* best_idx, int32_t* best, int32_t* second,
                     void* stream);

// K7: FAST-9 + Harris + disc NMS, dense; two kernels on `stream`.
// img: (h, w) uint8; radius 1..EFF_STAGED_MAX_RADIUS; disc_wdx: DEVICE
// array of 2*(radius-1)+1 half-widths, entry i for dy = i - (radius-1).
// resp: (h, w) float32 scratch, left holding the response map (as K8's
// out).  out: (h, w) float32, the response of surviving border-valid
// corners, -inf elsewhere.
int eff_fast_harris_nms(const uint8_t* img, int h, int w, int threshold,
                        int radius, const int32_t* disc_wdx, float harris_s2,
                        float* resp, float* out, void* stream);

// K8: FAST-9 + Harris, dense.  img: (h, w) uint8.  out: (h, w) float32, the
// response at border-valid corners, -inf elsewhere.
int eff_fast_harris(const uint8_t* img, int h, int w, int threshold,
                    float harris_s2, float* out, void* stream);

// K9: disc NMS of a -inf-masked (h, w) float32 response, any radius >= 1.
// disc_wdx: DEVICE array of 2*(radius-1)+1 half-widths, as for K7.
// out: (h, w) uint8 (a torch.bool tensor), 1 where center != -inf and
// center >= every response in the open disc.
int eff_radius_nms(const float* resp, int h, int w, int radius,
                   const int32_t* disc_wdx, uint8_t* out, void* stream);

// K10: bilinear u8 resize, 11-bit fixed point.  src: (sh, sw) uint8;
// y0, y1, wy1: (h,) and x0, x1, wx1: (w,) int32 DEVICE tables, the source
// indices and the weight of the second one (0..2048) per destination row
// and column (semantics.resize_axis_coeffs).  dst: (h, w) uint8, 4-byte
// aligned; h * w must fit int32.
int eff_resize_u8(const uint8_t* src, int sh, int sw, const int32_t* y0,
                  const int32_t* y1, const int32_t* wy1, const int32_t* x0,
                  const int32_t* x1, const int32_t* wx1, uint8_t* dst, int h,
                  int w, void* stream);

// K11: fused HashSIFT, K5 applied to K4's patch on chip.  Inputs as K4;
// plan, wpack and ori_scale as K5.  out: (n, 128) uint8, orientation-major,
// 8-byte aligned; invalid slots get zero rows.  Rows equal
// eff_hs_hist(eff_warp_patches(.)) byte for byte.
int eff_hs_desc(const uint8_t* img, int h, int w, const float* kx,
                const float* ky, const float* cos_s, const float* sin_s,
                const uint8_t* valid, int n, const int32_t* plan,
                const float* wpack, float ori_scale, uint8_t* out,
                void* stream);

// Blocks of K5 / K11 (8 patches each) that one SM of the current device
// holds at once, with the shared memory carveout the launches ask for.
int eff_hs_hist_blocks_per_sm(int* blocks);
int eff_hs_desc_blocks_per_sm(int* blocks);

// Text of a CUDA error code returned by the entry points above.
const char* eff_error_string(int code);

#ifdef __cplusplus
}
#endif

"""match_verify_ms (match and verify): device ms per step, in the traced
stretch, of the operations launched inside the benchmark's spans around
`knn2_ratio_match_masked` and `find_homography_ransac`."""

SPANS = ("knn2_ratio_match_masked", "find_homography_ransac")


def read(ctx):
    if ctx.tr is None or not ctx.frames_traced:
        return None
    us = sum(op.dur for op in ctx.tr.ops if op.span in SPANS)
    return us * 1e-3 / ctx.frames_traced if us > 0 else None

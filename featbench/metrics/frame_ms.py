"""frame_ms: the measured window's wall time over the frames completed in
it (a batch of B counts B frames), so a stall counts."""


def read(ctx):
    if ctx.frames_done < 1:
        return None
    return 1e3 * ctx.window_s / ctx.frames_done

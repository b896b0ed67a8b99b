"""The whole frame's share of the H100's float32 peak, in %: the operations
of the untraced frames of the window (``portbench/work.py``) over the
untraced window's wall time at 67 TFLOP/s.  It bounds the whole-frame
kernel's roofline share from below whatever kernel runs the frame."""

from portbench import work


def read(ctx):
    a, frames, seconds = ctx.untraced()
    if not frames or seconds <= 0:
        return None
    ops, _ = ctx.work(a, a + frames)
    return 100.0 * ops / (seconds * work.PEAK_F32_OPS_PER_S) if ops else None

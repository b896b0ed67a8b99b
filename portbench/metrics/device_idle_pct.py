"""The share of the untraced window in which the device is idle, in %: one
less the device time a frame (the profiler's timeline over the traced
episodes: any kernel, copy or memset) times the untraced frames, over the
untraced window's wall time.  The traced window's own idle share, which the
profiler's host time lengthens, is the result line's ``busy_s`` and
``window_s``; it is printed beside this one."""

from portbench import trace


def read(ctx):
    ctx.kernel_records()  # prints the records seen against the launches
    busy = ctx.device_busy_per_frame()
    _, frames, seconds = ctx.untraced()
    if busy is None or not frames or seconds <= 0:
        return None
    tr = ctx.window.trace
    ctx.log(f"device idle in the traced window "
            f"{100.0 * (1.0 - trace.busy_seconds(tr) / trace.window_seconds(tr))}"
            f" %, device {1e3 * busy:.6f} ms a frame")
    return 100.0 * (1.0 - busy * frames / seconds)

"""The window's rate, in reads/s, over the traced run's untraced rest:
every read of the batches completed after the profiler closed, over the
time from its close to the last batch's synchronize. The untraced run
logs the same rate over its whole window. It follows the host's speed
(the main thread is on the CPU for nearly all of the window), which
spread runs of one seed by up to a third on one card's machine."""


def read(ctx):
    reads, secs = ctx.get("untraced_reads", 0), ctx.get("untraced_s", 0.0)
    if not reads or secs <= 0:
        return None
    return reads / secs

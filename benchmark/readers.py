"""What the per-layer metrics of ``metrics/`` share: shares of the traced
window, of the chip's f32 peak and of a kernel's roofline, from the run's
facts and trace and the reference's work counts. Each returns None where
the run has nothing for it to read."""

from __future__ import annotations

from benchmark.reference import work


def idle_percent(run):
    """Share of the traced window in which no device operation ran."""
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def mfu_percent(run, images: str, train: bool):
    """Matrix FLOPs a second over the f32 peak of the run's cards, in a
    traced run on the card: ``images`` the run's fact that counts the
    images the window completed (over every card), each at the reference's
    count of a served image or (``train``) of a training step's image."""
    n = getattr(run, images, None)
    if not run.trace or not n or run.window_s <= 0:
        return None
    ctx = run.context
    flops = work.flops_per_image(ctx.build_reference, ctx.hierarchy,
                                 run.config["model"]["image_size"], train)
    return 100.0 * n / run.window_s * flops / (run.chips * work.PEAK_F32_FLOPS)


def roofline_percent(run, kernel: str, least_seconds: float):
    """The least time for one launch's work over the mean device time of
    the traced launches whose name holds ``kernel``."""
    if not run.trace:
        return None
    times = [s for name, s in run.trace["kernels"] if kernel in name]
    if not times:
        return None
    return 100.0 * least_seconds / (sum(times) / len(times))

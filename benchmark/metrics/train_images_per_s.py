"""Training images stepped in the window over its seconds (host clock; the
window ends in a synchronize)."""


def read(run):
    if not getattr(run, "steps", None):
        return None
    return run.train_images / run.window_s

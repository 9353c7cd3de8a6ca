"""Images completed in the window over its seconds (host clock; the window
ends when the last request's result is on the host)."""


def read(run):
    if not getattr(run, "requests", None):
        return None
    return run.images / run.window_s

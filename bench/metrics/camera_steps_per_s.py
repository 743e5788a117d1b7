"""Camera-steps a second: cameras x steps completed in the timed window,
over the window's seconds (host clock)."""


def read(ctx):
    w = ctx["window"]
    return ctx["dims"]["n_cameras"] * w.steps / w.seconds

"""The device's peak allocated memory over set-up and the window, GiB
(torch.cuda.max_memory_allocated)."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30

"""Share of the window the feeding side spent waiting in ``next(loader)``
(the program's `data/zip_dataset.py` loader), from the harness's span
around each call."""


def read(ctx):
    if ctx.get("data_wait_s") is None:
        return None
    return 100.0 * ctx["data_wait_s"] / ctx["data_window_s"]

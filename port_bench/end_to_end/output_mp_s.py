"""Output megapixels of every burst completed in the window, over the
window's seconds (the first timed call to the last burst's completion)."""


def read(run):
    return run.output_pixels * len(run.latencies_s) / 1e6 / run.window_s

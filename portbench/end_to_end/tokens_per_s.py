"""tokens_per_s: training throughput per card. All tokens of the steps
completed in the window, over the window's whole time (its start to the
synchronize after its last step, the slowest rank's), divided by the
cards."""


def read(res: dict):
    return res["tokens"] / res["window_s"] / res["world"]

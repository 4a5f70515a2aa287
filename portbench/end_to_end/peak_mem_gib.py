"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window
(reset after the warm-up), of the fullest card, in GiB."""


def read(res: dict):
    return res["peak_bytes"] / 2 ** 30

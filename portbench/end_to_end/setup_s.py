"""setup_s: from the start of the benchmark's process to the first timed
step: imports (their bytecode, like the kernels, compiled on a
checkout's first run), the kernels loaded, the ranks and their group
started, the weights made on the card from the seed, the checked steps
that warm the cell's shapes."""


def read(res: dict):
    return res["setup_s"]

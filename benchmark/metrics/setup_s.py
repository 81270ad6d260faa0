"""setup_s: seconds from the process's start (torch's import in it) to
the end of set-up: weights and frames made on the card, the program built,
its kernels loaded (built on a checkout's first run) and every shape of
the cell warmed up."""


def read(run):
    return run.setup_s

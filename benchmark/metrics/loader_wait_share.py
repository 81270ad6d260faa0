"""loader_wait_share: percent of the (untraced) window that the trainer's
iteration waited in ``BatchLoader.next_batch`` (host clock around each
call)."""


def read(run):
    if run.mode != 'train' or not run.window_s:
        return None
    return sum(run.waits) / run.window_s * 100

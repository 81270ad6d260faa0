"""frames_per_s: every frame answered in the window over the window's
length (host clock, from the first call's start to the last one's end)."""


def read(run):
    return run.items_per_s if run.mode == 'infer' else None

"""train_images_per_s: the images of every applied step of the window
over the window's length (host clock, from the first step's call to the
loader to the end of the synchronize after the last step); a skipped
(non-finite) step's images are failed, not trained."""


def read(run):
    return run.items_per_s if run.mode == 'train' else None

"""train_img_per_s: the images of every step of the window over the window,
which ends when the device has finished the last step."""


def read(rec):
    w = rec["window"]
    return w["images"] / w["seconds"]

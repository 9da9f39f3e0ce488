"""Images whose train step finished in the window over the window's
seconds, by the harness's clock; the profiled steps and their time are
left out. The host sets most of a step, so the rate swings with the
host's speed from run to run and stands here beside `train_device_ms`,
which it moves."""


def read(span, run):
    steady = span["window"] - span["prof_span"]
    images = span["images"] - span["prof_images"]
    return images / steady if steady > 0 and images > 0 else None

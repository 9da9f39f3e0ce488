"""Share of the window's host time spent between two train steps: taking
the next batch from `device_prefetch` (the loader's queue and the copy to
the card) and the loop's own work, by the harness's clock around each step
call; the profiled steps are left out of both sides. Moves
`rl_train_images_per_s`."""


def read(span, run):
    steady = span["window"] - span["prof_span"]
    return 100.0 * span["wait"] / steady if steady > 0 else None

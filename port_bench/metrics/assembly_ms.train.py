"""Host milliseconds an image of batch assembly (decode, flip, resize,
crop, pad on a loader thread) over the batches assembled in the window,
by the harness's clock around the loader's `assemble_job`. Moves
`train_device_ms`."""


def read(span, run):
    done = [(ms, n) for end, ms, n in span["loader_times"]
            if span["t_start"] <= end <= span["t_end"]]
    return sum(ms for ms, _ in done) / sum(n for _, n in done) if done else None

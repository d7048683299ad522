"""graphs.warmup_capture_s: seconds the trainer's CUDA graphs took to warm
up, capture and instantiate during set-up (the program's counters
``Graphs.warmup_s`` and ``Graphs.capture_s``)."""


def read(ctx):
    g = ctx.get("graphs")
    return None if not g else g["warmup_s"] + g["capture_s"]

"""Device memory a call costs: the peak of torch.cuda.max_memory_allocated
over the window (the input pool on the device included), less the
sampled answers the harness keeps for the check, over one call's input
bytes."""
UNIT = "B/B"


def read(run):
    if run.memory_peak_bytes is None or run.input_bytes <= 0:
        return None
    return (run.memory_peak_bytes - run.held_bytes) / run.input_bytes

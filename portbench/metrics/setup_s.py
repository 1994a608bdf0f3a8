"""Set-up: from the start of the run's process to the window's start:
imports, the kernels' build check (the build itself on a first run),
the inputs made from the seed, and the warm-up calls."""
UNIT = "s"


def read(run):
    return run.setup_s

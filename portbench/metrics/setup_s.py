"""setup_s: seconds from the run's start to its window: the inputs
made from the seed, the program loaded and built on the device (in a
run that compiles, the compile), and the warm-up."""


def read(run):
    return run.setup_s
